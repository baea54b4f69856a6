"""Usage examples of the port (counterparts of the repository's
``examples/``), each a module:

    python -m simd_dct_tpu_torch.examples.<name> [--device cuda|cpu]

``encode_decode`` (mode32, the ``.sdt`` container, the native stereo
layout), ``video_pipeline`` (the ``.sdtv`` container and the frame feed),
``serving`` (sparse and dense stream formats, streaming decode) and
``sharded`` (a mesh of 8 shards of one device).  Each runs on the card
unless ``--device cpu`` asks for the host, and each ``main(argv)`` returns
the lines it printed.
"""

from __future__ import annotations

import argparse


def device_arg(argv, doc: str) -> str | None:
    """The ``--device`` of an example's command line (None: the card)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain version on the "
                    "host")
    return ap.parse_args([] if argv is None else argv).device


class Lines(list):
    """The lines an example printed, in order."""

    def __call__(self, text: str) -> None:
        print(text, flush=True)
        self.append(text)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"example check failed: {what}")
