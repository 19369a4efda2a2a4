"""PyTorch + CUDA port of the LPQ-ANN system (``repro``), one slice at a time.

The JAX/Pallas package ``repro`` is the reference; this package mirrors its
layout (``repro_torch/<pkg>/<mod>.py`` <-> ``repro/<pkg>/<mod>.py``) and
public names wherever the idea carries over.  It imports ``torch`` and numpy
only: never ``jax``, never anything under ``repro.``.

Ported so far: the exhaustive-search serving path (``flat``,
``flat,lpq8``, ``flat,lpq4``, ``+r32``) with hand-written Hopper kernels
for Eq. 1 quantize (B1) and the fused score + top-k scans (B2 int8/fp32,
B3 packed int4), and the PQ / ADC path (``pq<M>+lpq``, ``pq<M>x4+lpq``,
``pq<M>``, ``,r32``) with the fused ADC + top-k kernels (B4, B5), and
recsys candidate retrieval (``models.recsys``, ``launch.make_retrieval``)
with the score-matrix kernels (B6 ``qmip``, B7 ``ql2``, B8 ``qmip4`` /
``ql24``), all under ``csrc/``.

Numerics: the fp32 arm is the ground truth every quantized arm is measured
against, so TF32 is switched off for matmuls and cuDNN here, at import.
A TF32 product keeps ~3 decimal digits and would make the fp32 arm a
different, lossy index.
"""

import torch

# fp32 ground truth: full-precision float32 products on the card (TF32 off)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
