"""The four recsys architectures over the shared embedding + interaction
substrate (port of ``repro.models.recsys.models``): ``init_params``,
``forward`` (the CTR logit), ``serve`` (online and bulk scoring) and
``bce_loss`` (differentiable: ``launch.steps.make_recsys_train_step``), with
``RecsysConfig``.  Candidate retrieval, the paper's search problem, is
``retrieval.py``.

Parameters are nested dicts of tensors with the reference's keys and
shapes.  ``init_params`` draws from one explicit ``torch.Generator`` on
``device``; the reference's ``jax.random`` draws cannot be reproduced, so
tests carry its parameters across (``convert.recsys_params_from_reference``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E
from repro_torch.models.recsys import interactions as I


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                          # autoint | dlrm | dien | dcnv2
    n_dense: int
    vocab_sizes: tuple[int, ...]
    embed_dim: int
    # autoint
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    # dlrm
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    # dien
    seq_len: int = 0
    gru_dim: int = 0
    mlp: tuple[int, ...] = ()
    # dcn-v2
    n_cross_layers: int = 0
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype named by ``dtype``."""
        return getattr(torch, self.dtype)

    @property
    def jdtype(self) -> torch.dtype:
        """The reference's name for ``tdtype``."""
        return self.tdtype

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def param_count(self) -> int:
        counts = sum(v * self.embed_dim for v in self.vocab_sizes)
        return counts  # tables dominate; MLPs counted at init if needed


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: RecsysConfig, device=None):
    """The parameter tree of ``cfg``, drawn from ``generator`` (which must
    live on ``device``; ``None``: the GPU)."""
    dt, d, dev = cfg.tdtype, cfg.embed_dim, device
    p = {"tables": E.multi_table_init(generator, cfg.vocab_sizes, d, dt,
                                      device=dev)}

    if cfg.kind == "autoint":
        dims = [d] + [cfg.n_heads * cfg.d_attn] * cfg.n_attn_layers
        p["attn"] = {
            f"a{i}": I.autoint_layer_init(generator, dims[i], cfg.n_heads,
                                          cfg.d_attn, dt, device=dev)
            for i in range(cfg.n_attn_layers)
        }
        p["out"] = L.mlp_init(generator, [dims[-1] * cfg.n_sparse, 1], dt,
                              device=dev)

    elif cfg.kind == "dlrm":
        p["bot"] = L.mlp_init(generator, [cfg.n_dense, *cfg.bot_mlp], dt,
                              device=dev)
        n_feats = cfg.n_sparse + 1                       # sparse + bottom output
        d_inter = n_feats * (n_feats - 1) // 2
        p["top"] = L.mlp_init(generator,
                              [d_inter + cfg.bot_mlp[-1], *cfg.top_mlp], dt,
                              device=dev)

    elif cfg.kind == "dien":
        p["gru"] = I.gru_init(generator, d, cfg.gru_dim, dt, device=dev)
        p["augru"] = I.gru_init(generator, cfg.gru_dim, cfg.gru_dim, dt,
                                device=dev)
        p["att"] = L.mlp_init(generator, [cfg.gru_dim + d, 36, 1], dt,
                              device=dev)
        # final MLP over [target_embed, final_interest, other fields]
        d_in = d * cfg.n_sparse + cfg.gru_dim
        p["out"] = L.mlp_init(generator, [d_in, *cfg.mlp, 1], dt, device=dev)

    elif cfg.kind == "dcnv2":
        d_in = cfg.n_dense + cfg.n_sparse * d
        p["cross"] = I.cross_init(generator, d_in, cfg.n_cross_layers, dt,
                                  device=dev)
        p["deep"] = L.mlp_init(generator, [d_in, *cfg.mlp], dt, device=dev)
        p["out"] = L.mlp_init(generator, [d_in + cfg.mlp[-1], 1], dt,
                              device=dev)
    else:
        raise ValueError(cfg.kind)
    return p


def abstract_params(cfg: RecsysConfig):
    """The parameter tree's shapes and dtypes, as tensors on the meta
    device (nothing is allocated)."""
    return init_params(torch.Generator(), cfg, device="meta")


# --------------------------------------------------------------------------
# forward per kind
# --------------------------------------------------------------------------

def _forward_autoint(params, cfg, batch):
    x = E.multi_lookup(params["tables"], batch["sparse"])       # [B, F, d]
    for i in range(cfg.n_attn_layers):
        x = I.autoint_layer(params["attn"][f"a{i}"], x, cfg.n_heads)
    return L.mlp(params["out"], x.reshape(x.shape[0], -1))[:, 0]


def _forward_dlrm(params, cfg, batch):
    dense_v = L.mlp(params["bot"], batch["dense"], final_act=True)  # [B, d]
    sparse_v = E.multi_lookup(params["tables"], batch["sparse"])    # [B, F, d]
    feats = torch.cat([dense_v[:, None, :], sparse_v], dim=1)
    inter = I.dot_interaction(feats)                                # [B, .]
    top_in = torch.cat([dense_v, inter], dim=-1)
    return L.mlp(params["top"], top_in)[:, 0]


#: DIEN's score for a masked history step: finite, so a row with no
#: history gets uniform attention weights (the reference's), not NaN
_MASKED = -1e30


def _forward_dien(params, cfg, batch):
    target = E.lookup(params["tables"]["t0"], batch["sparse"][:, 0])   # [B, d]
    others = E.multi_lookup(params["tables"], batch["sparse"])          # [B, F, d]
    hist = E.lookup(params["tables"]["t0"], batch["hist_ids"])          # [B, T, d]
    mask = batch["hist_mask"]

    states = I.gru_scan(params["gru"], hist, mask)                      # [B, T, g]
    # attention of target on interest states
    tgt = target[:, None, :].expand(hist.shape)
    att_in = torch.cat([states, tgt], dim=-1)
    scores = L.mlp(params["att"], att_in)[..., 0]
    scores = torch.where(mask > 0, scores,
                         torch.full_like(scores, _MASKED))
    att = torch.softmax(scores, dim=-1)
    final = I.augru_scan(params["augru"], states, att, mask)            # [B, g]

    flat = torch.cat([others.reshape(others.shape[0], -1), final], dim=-1)
    return L.mlp(params["out"], flat)[:, 0]


def _forward_dcnv2(params, cfg, batch):
    sparse_v = E.multi_lookup(params["tables"], batch["sparse"])
    x0 = torch.cat([batch["dense"], sparse_v.reshape(sparse_v.shape[0], -1)],
                   dim=-1)
    xc = I.cross_apply(params["cross"], x0)
    xd = L.mlp(params["deep"], x0, final_act=True)
    return L.mlp(params["out"], torch.cat([xc, xd], dim=-1))[:, 0]


_FWD = {
    "autoint": _forward_autoint,
    "dlrm": _forward_dlrm,
    "dien": _forward_dien,
    "dcnv2": _forward_dcnv2,
}


def forward(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """CTR logit [B] of a batch of tensors on the parameters' device."""
    return _FWD[cfg.kind](params, cfg, batch)


def bce_loss(params, batch, cfg: RecsysConfig):
    """Mean binary cross-entropy of the logits against ``batch["label"]``,
    in the reference's stable form; returns (loss, {"logit_mean"})."""
    logit = forward(params, batch, cfg)
    y = batch["label"]
    loss = torch.mean(
        torch.clamp_min(logit, 0) - logit * y
        + torch.log1p(torch.exp(-torch.abs(logit)))
    )
    return loss, {"logit_mean": torch.mean(logit)}


def serve(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """Online scoring: sigmoid CTR probability [B]."""
    return torch.sigmoid(forward(params, batch, cfg))
