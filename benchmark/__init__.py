"""The benchmark of ``simd_dct_tpu_torch``: see ``README.md``."""
