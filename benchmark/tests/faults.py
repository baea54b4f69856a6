"""Faults a cell can have, each a wrapper around the function that makes a
call's output: planted in the plain tier under the api on the CPU, or
around the api's entry on the card."""

# each cell and the function its api call ends in, named alike in the api
# and in the plain tier
CELLS = {"uhd_stereo.enc.b8": "encode_quantize_stereo",
         "video1080p.rt.b64": "roundtrip_quantize32",
         "video1080p.enc.b64": "encode_quantize32",
         "uhd_stereo.dec.b8": "decode_quantize_stereo"}


def unwritten(fn):
    """The output buffer handed back as allocated, never written."""
    def f(*a, **k):
        return fn(*a, **k).zero_()
    return f


def half_batch(fn):
    """Half of the batch left out: the second half of the frames is never
    computed."""
    def f(x, *a, **k):
        out = fn(x, *a, **k)
        out[x.shape[0] // 2:] = 0
        return out
    return f


def short(fn):
    """The last frame of the batch dropped from the output."""
    def f(*a, **k):
        return fn(*a, **k)[:-1]
    return f


def altered(fn):
    """One answer altered where it is produced: a byte of the first frame
    off by 2."""
    def f(*a, **k):
        out = fn(*a, **k)
        flat = out[0].view(-1)
        flat[flat.numel() // 3] += 2
        return out
    return f


FAULTS = [unwritten, half_batch, short, altered]
