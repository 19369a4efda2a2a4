"""The paper's quantization family (Q, phi) in torch: Eq. 1 constants and
codes, integer-domain distances, int4 packing, recall."""
