"""Functional kernels over planar (2, 2^n) amplitude tensors: the per-gate
engine (apply, diagonal), the readouts (reduce, measure), the initial
states (init) and the fused gate-run kernel (fused_gates)."""
