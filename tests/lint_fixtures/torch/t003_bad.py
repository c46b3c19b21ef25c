"""BAD (when linted as src/repro_torch/kernels/...): kernel entry points
called without build.launch, so they launch on the current device."""
import ctypes

from repro_torch.kernels import build


def _lib():
    lib = build.load("foo")
    if not getattr(lib, "_typed", False):
        lib.foo_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
        lib._typed = True
    return lib


def run(x):
    lib = _lib()
    return lib.foo_launch(x.data_ptr(), x.numel(), None)     # T003


def run_inline(x):
    return _lib().foo_launch(x.data_ptr(), x.numel(), None)  # T003


def run_loaded(x):
    lib = build.load("foo")
    return lib.foo_launch(x.data_ptr(), x.numel(), None)     # T003
