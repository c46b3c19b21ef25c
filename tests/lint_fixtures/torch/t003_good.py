"""GOOD: every launch through build.launch; host-only queries direct."""
import ctypes

from repro_torch.kernels import build


def _lib():
    lib = build.load("foo")
    if not getattr(lib, "_typed", False):
        lib.foo_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
        lib.foo_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def run(x):
    lib = _lib()
    if _lib().foo_smem_bytes(64) > 227 * 1024:
        raise ValueError("too much shared memory")
    rc = build.launch(lib.foo_launch, x.device, x.data_ptr(), x.numel())
    if rc != 0:
        raise RuntimeError(lib.foo_error_string(rc).decode())
