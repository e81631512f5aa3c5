"""Functional kernels over planar (2, 2^n) amplitude tensors: the per-gate
engine (apply, diagonal), the readouts (reduce, measure), the initial
states (init), the fused gate-run kernel (fused_gates) and the dense
window kernel (window_dot)."""
