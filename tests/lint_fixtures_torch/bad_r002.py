"""R002 fixture: a kernel op registered in the factory's loop form with
its plain version only: no CUDA kernel, one impl, no parity test and no
card check."""


def register_kernel(op, impl, fn, **kw):
    """Stand-in with the factory's signature; the rule is AST-driven."""


def _plain(x):
    return x


for op, plain in (("twiddle_rows", _plain),):
    register_kernel(op, "torch", plain)
