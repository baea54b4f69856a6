"""Verification aids (counterpart of ``simd_dct_tpu/utils/debug.py``):
the cross-backend diff contract and a determinism check."""

from __future__ import annotations

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_deterministic(fn, args=(), runs: int = 3) -> bool:
    """Run ``fn`` repeatedly and check bit-identical outputs (a tensor or a
    tuple/list of tensors).  Every kernel of the port is deterministic: no
    atomics, no reduction across threads."""
    ref = None
    for _ in range(runs):
        out = fn(*args)
        leaves = [_to_numpy(x) for x in
                  (out if isinstance(out, (tuple, list)) else (out,))]
        if ref is None:
            ref = leaves
        elif len(leaves) != len(ref) or not all(
                np.array_equal(a, b) for a, b in zip(ref, leaves)):
            return False
    return True


def compare_backends(encode_calls: dict[str, object], *,
                     max_abs_diff: int = 1,
                     max_mismatch_rate: float = 0.002) -> dict[str, dict]:
    """Every pair of outputs must agree within the +-1 rounding-boundary
    contract, on at most ``max_mismatch_rate`` of the bytes."""
    names = list(encode_calls)
    outs = {n: _to_numpy(encode_calls[n]).reshape(-1) for n in names}
    report = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            diff = outs[a].astype(np.int16) - outs[b].astype(np.int16)
            n_bad = int(np.count_nonzero(diff))
            max_diff = int(np.abs(diff).max(initial=0))
            report[f"{a}-vs-{b}"] = {
                "max_abs_diff": max_diff,
                "mismatch_rate": n_bad / diff.size,
                "ok": (max_diff <= max_abs_diff
                       and n_bad <= diff.size * max_mismatch_rate),
            }
    return report
