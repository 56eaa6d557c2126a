"""refcpu — reference-faithful CPU comparators (quality yardstick only).

These modules re-implement, in plain numpy, the *exact search algorithms* of
the reference encoders (AMD BC7 AnD quantizer + endpoint shakers, AMD BC6H,
bc7enc16, AMD BCX) so the TPU framework's PSNR can be measured against the
reference's achievable quality without the C++ tree. They are correctness-
not-speed code, used by bench_quality.py and the quality-gate tests; the
production TPU path lives in kernels/.

They are NOT translations of the reference source: the algorithms were
re-derived from a close reading (citations inline) and expressed in
vectorized numpy, with the reference's precomputed 100 MB+ table machinery
replaced by small on-demand caches.
"""
