"""Backend tiers and the capability probe (counterpart of
``simd_dct_tpu/dispatch/capability.py``).

    tier "cuda"  -- the hand-written kernels (kernels/cuda_dct.py)
    tier "torch" -- the plain PyTorch version (kernels/torch_path.py)
    tier "numpy" -- the scalar NumPy golden (core/golden.py), on the host

Device rule: a CUDA tensor goes to the ``cuda`` tier and a CPU tensor to
the ``torch`` tier.  Data that is not a tensor yet is placed on the card
unless the caller names another device (``default_device``); with no card
that raises, it never falls back to the host.  ``set_max_backend("torch")``
caps a CUDA tensor to the plain version on the card (the counterpart of
``--max-simd``).  ``numpy``, asked for by ``backend="numpy"`` or by the
cap ``set_max_backend("numpy")`` (``--max-simd none``), is the golden: a
host tier, so data that is not a tensor yet goes to the CPU for it
(``default_device``), and a CUDA tensor under it raises ``NotSupportedError`` (move it
with ``.cpu()``), as a CPU tensor under ``cuda`` does.  Unlike the JAX
package's probe, which degrades quietly when its trial compile fails,
``probe()`` on a machine with a GPU builds the library, launches the trial
kernel, and raises if either step fails.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

TIERS = ("cuda", "torch", "numpy")

_max_backend: str = "cuda"


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str          # 'cuda' or 'cpu'
    device_kind: str       # torch.cuda.get_device_name(0), or 'cpu'
    num_devices: int
    supports_cuda: bool

    @property
    def banner(self) -> str:
        return (f"{self.device_kind} x{self.num_devices} "
                f"[{self.platform}] cuda={self.supports_cuda}")


def _trial_kernel() -> None:
    """Build the library and run the trial kernel on the card; raise
    unless it returns the plain version's bytes."""
    from ..kernels import _build, cuda_dct, torch_path
    _build.load()
    x = (torch.arange(8 * 128, device="cuda") % 256).to(torch.uint8)
    x = x.reshape(8, 128)
    got = cuda_dct.probe_trial(x)
    if not torch.equal(got, torch_path.probe_trial(x)):
        raise RuntimeError("the CUDA trial kernel returned wrong bytes")


@functools.lru_cache(maxsize=1)
def probe() -> DeviceInfo:
    """What this machine offers.  Cached after the first success; a
    failure raises and is not cached."""
    if not torch.cuda.is_available():
        return DeviceInfo(platform="cpu", device_kind="cpu", num_devices=0,
                          supports_cuda=False)
    _trial_kernel()
    return DeviceInfo(platform="cuda",
                      device_kind=torch.cuda.get_device_name(0),
                      num_devices=torch.cuda.device_count(),
                      supports_cuda=True)


def available_tiers() -> tuple[str, ...]:
    """Tiers usable on this machine, strongest first: ``numpy`` always."""
    return TIERS if probe().supports_cuda else ("torch", "numpy")


def set_max_backend(tier: str, *, strict: bool = False) -> None:
    """Cap dispatch at a tier (the counterpart of ``--max-simd``);
    ``numpy`` forces the golden.  With ``strict=True`` the tier must be
    available on this machine."""
    global _max_backend
    if tier not in TIERS:
        raise ValueError(f"unknown backend tier {tier!r}; expected one of {TIERS}")
    if strict and tier not in available_tiers():
        from ..api import NotSupportedError
        raise NotSupportedError(
            f"requested backend cap {tier!r} is not supported on this "
            f"machine (available: {available_tiers()})")
    _max_backend = tier


def get_max_backend() -> str:
    return _max_backend


def is_numpy_tier(requested: str | None = None) -> bool:
    """Whether a call with this ``backend=`` runs the golden: asked for,
    or no request under the cap ``numpy``."""
    return requested == "numpy" or (requested is None
                                    and _max_backend == "numpy")


def default_device(device=None, backend: str | None = None) -> torch.device:
    """Where data that is not a tensor yet goes: ``device``; when it is
    None, the host for a call with this ``backend=`` that runs the numpy
    tier (the golden is a host tier), else the card.  A CUDA device on a
    machine without one raises ``NotSupportedError``, which names
    ``device="cpu"``."""
    if device is None and is_numpy_tier(backend):
        return torch.device("cpu")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        from ..api import NotSupportedError
        raise NotSupportedError(
            "no CUDA device on this machine: the entry points run on the "
            'card unless the caller asks for the host; pass device="cpu" '
            "(or a CPU tensor) to run the plain version there")
    return dev


def select_backend(requested: str | None = None, *,
                   device: torch.device | str | None = None) -> str:
    """The tier for a call on data that lies on ``device``: an explicit
    request, else the device rule under the global cap.  ``cuda`` for data
    that is not on a CUDA device, and ``numpy`` for data that is not on the
    host, raise ``NotSupportedError``: the data is never moved quietly."""
    from ..api import NotSupportedError
    if requested is not None and requested not in TIERS:
        raise ValueError(f"unknown backend {requested!r}; expected one of {TIERS}")
    dev = torch.device(device) if device is not None else None
    on_cuda = dev is not None and dev.type == "cuda"
    if is_numpy_tier(requested):
        if dev is not None and dev.type != "cpu":
            raise NotSupportedError(
                f"backend 'numpy' is the host golden; the data lies on {dev} "
                "(move it with .cpu() first)")
        return "numpy"
    if requested == "cuda":
        if dev is not None and not on_cuda:
            raise NotSupportedError(
                f"backend 'cuda' needs CUDA tensors; the data lies on {dev} "
                "(move it with .to('cuda') first)")
        if "cuda" not in available_tiers():
            raise NotSupportedError(
                "backend 'cuda' is not available on this machine "
                f"(available: {available_tiers()})")
        return "cuda"
    if requested == "torch" or not on_cuda or _max_backend == "torch":
        return "torch"
    available_tiers()   # builds and probes the kernels; raises on failure
    return "cuda"
