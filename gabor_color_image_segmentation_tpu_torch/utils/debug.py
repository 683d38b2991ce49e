"""NaN checking of every operation: the port's counterpart of the JAX
package's ``jax_debug_nans`` (``eval.evaluate(debug_nans=True)``, ``cli eval
--debug-nans``).

``debug_nans()`` is a context manager that installs ``NanCheckMode``, a
``TorchDispatchMode``: every aten operation run inside it, on any device,
has its floating-point outputs checked, and the first one that holds a NaN
raises ``FloatingPointError`` naming the operation, as jax_debug_nans
raises naming the primitive. Views are not checked (they make no values),
nor are the uninitialised allocations (``empty``, ``empty_like``,
``empty_strided``, ``new_empty``, ...) whose memory holds whatever was
there: their storages are remembered, and an operation that writes into
one of them (a copy into a slice, an indexed store) is not checked either;
what reads them again makes new tensors, which are.

The hand-written kernels write their outputs through ``ctypes``, outside
the dispatcher, so ``_kernels.launch`` hands each launch's floating-point
outputs to ``check_kernel_outputs``, which checks them (and marks them
written) while a ``NanCheckMode`` is active and does nothing otherwise.

Each check reads a flag back from the device, so every operation waits for
the one before: the mode is a debugging aid, slow on purpose. Outside it
nothing is checked and nothing is added but the launches' one test of the
dispatch-mode stack.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Iterable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

# aten operations whose outputs are uninitialised memory
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided", "empty_permuted",
                            "new_empty", "new_empty_strided"})


def _tensors(out) -> list:
    return [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]


class NanCheckMode(TorchDispatchMode):
    """Raise FloatingPointError at the first operation whose floating-point
    output holds a NaN (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self._unwritten = weakref.WeakSet()  # storages of uninitialised allocations

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            for t in _tensors(out):
                self._unwritten.add(t.untyped_storage())
        elif not func.is_view:
            self.check(str(func), _tensors(out))
        return out

    def check(self, what: str, tensors: Iterable[torch.Tensor]) -> None:
        """Raise FloatingPointError naming ``what`` if one of ``tensors``
        (those that hold floating-point values) holds a NaN."""
        for t in tensors:
            if (t.layout != torch.strided or t.device.type == "meta"
                    or not (t.is_floating_point() or t.is_complex())
                    or t.untyped_storage() in self._unwritten):
                continue
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(f"invalid value (nan) encountered in {what}")

    def written(self, what: str, tensors: Iterable[torch.Tensor]) -> None:
        """``tensors`` were written outside the dispatcher (a kernel's
        outputs): they hold values now; check them."""
        tensors = list(tensors)
        for t in tensors:
            self._unwritten.discard(t.untyped_storage())
        self.check(what, tensors)


def active_mode() -> Optional[NanCheckMode]:
    """The innermost active NanCheckMode, or None."""
    if torch._C._len_torch_dispatch_stack() == 0:
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, NanCheckMode):
            return mode
    return None


def check_kernel_outputs(name: str, outputs: Iterable[torch.Tensor]) -> None:
    """A kernel launch's outputs, checked under an active NanCheckMode
    (raising FloatingPointError naming the kernel); nothing otherwise."""
    mode = active_mode()
    if mode is not None:
        mode.written(f"kernel {name}", outputs)


@contextlib.contextmanager
def debug_nans(enabled: bool = True) -> Iterator[None]:
    """Run the block under a NanCheckMode (nothing when ``enabled`` is
    False)."""
    if not enabled:
        yield
        return
    with NanCheckMode():
        yield
