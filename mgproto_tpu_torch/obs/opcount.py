"""Counted cost of a program run: FLOPs and bytes under a TorchDispatchMode.

The port's stand-in for what the JAX package reads from XLA (the compiled
module's cost analysis and its StableHLO byte model, mgproto_tpu/obs/
stall.py): the port compiles no program, so it counts one real run of it.
`OpCounter` sees every aten op that reaches the dispatcher while it is
active (the backward's too) and charges each one row per op name:

  flops        torch.utils.flop_counter's formulas (conv, matmul,
               attention); elementwise work counts 0, as there.
  bytes        the op's tensor operands and results, numel x itemsize
               each: the raw, unfused view (an in-place op reads and writes
               its operand). A view op, an op with no tensor result (a
               host read such as `.item()`, `record_stream`), and a copy
               between devices (a host constant sent to the card: on the
               CPU there is none) charge nothing.
  fused_bytes  the same, only for the classes of the JAX model's
               `_MAJOR_OPS` (conv, matmul, reduce, gather or scatter, sort,
               cat, a copy into a view, random draws): the ideal-fusion
               floor, where every elementwise op folds into a major one.

Two kinds of work are charged by rule instead of by their ops, so that the
CPU and the card count one program the same way:

  * the four kernels: each wrapper (ops/fused_scoring.py,
    ops/fused_epilogue.py, ops/em_kernels.py) reports its analytic FLOPs
    and bytes through `counted` as one row `kernel:<name>`, and the counter
    does not look inside. On the card a kernel is a ctypes launch that no
    dispatch mode sees; on the CPU its plain version's aten ops would be
    counted in its place.
  * an optimizer's step (torch.optim's global step hooks): one row
    `optimizer:<class>` at its ideal traffic, each parameter with a
    gradient read with its gradient and its state tensors of its size, the
    parameter and those states written. torch runs a per-tensor loop on the
    CPU and foreach kernels on CUDA; their op lists differ, the update
    does not.

An op without a FLOP formula that decomposes (a CompositeImplicit op
such as `aten.conv2d`, which reaches the mode undecomposed under
`torch.inference_mode`) is counted as its decomposition, as
`torch.utils.flop_counter` does, so a served forward counts as a trained
one. `counted` is one module-global None check when no counter is
active.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ACTIVE: Optional["OpCounter"] = None
_OFF = contextlib.nullcontext()

# aten op names (in-place suffix stripped) whose traffic survives ideal
# fusion: the JAX model's _MAJOR_OPS, by class
_MAJOR = frozenset((
    # conv, matmul
    "convolution", "convolution_backward", "_convolution", "cudnn_convolution",
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "dot", "mv", "addmv", "_scaled_mm",
    # reduce, reduce_window, select_and_scatter
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod", "var", "std",
    "var_mean", "std_mean", "logsumexp", "norm", "linalg_vector_norm", "all", "any",
    "cumsum", "cumprod", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "max_pool2d_with_indices",
    "max_pool2d_with_indices_backward", "avg_pool2d", "avg_pool2d_backward",
    "_adaptive_avg_pool2d", "_adaptive_avg_pool2d_backward", "nll_loss_forward",
    "nll_loss_backward", "count_nonzero",
    # gather, scatter, dynamic slice
    "gather", "scatter", "scatter_add", "scatter_reduce", "index", "index_select",
    "index_put", "_index_put_impl", "index_add", "index_copy", "embedding",
    "embedding_dense_backward", "take", "slice_scatter", "select_scatter", "masked_select",
    "nonzero",
    # sort, concatenate, random draws
    "sort", "topk", "argsort", "kthvalue", "cat", "stack",
    "uniform", "normal", "bernoulli", "random", "randint", "rand", "randn", "randperm",
))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _row(rows: Dict[str, Dict[str, Any]], name: str, major: bool) -> Dict[str, Any]:
    return rows.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0,
                                  "fused_bytes": 0.0, "fused": major})


class _Charged:
    """The body of `counted` while a counter is active: one row, and the
    counter suspended for what runs inside."""

    def __init__(self, counter: "OpCounter", name: str, flops: float, nbytes: float):
        self.counter, self.name, self.flops, self.nbytes = counter, name, flops, nbytes

    def __enter__(self):
        self.counter.charge(self.name, self.flops, self.nbytes, major=True)
        self.counter.suspended += 1

    def __exit__(self, *exc):
        self.counter.suspended -= 1
        return False


def counted(kernel: str, flops: float, nbytes: float):
    """Context of a kernel wrapper's work: with a counter active, one row
    `kernel:<kernel>` of the given analytic FLOPs and bytes, and nothing
    that runs inside counted; otherwise a shared no-op context."""
    counter = _ACTIVE
    if counter is None:
        return _OFF
    return _Charged(counter, f"kernel:{kernel}", float(flops), float(nbytes))


class _CountingMode(TorchDispatchMode):
    """The dispatch mode behind an OpCounter."""

    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        counter = self.counter
        if not counter.suspended and func.overloadpacket not in _flop_registry():
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not counter.suspended and not func.is_view:
            counter.count_op(func, args, kwargs, out)
        return out


class OpCounter:
    """Counts the aten ops run while it is entered, into `rows[phase]`
    (module docstring); `phase` may change between the program's parts.
    One counter is active in a process at a time."""

    def __init__(self, phase: str = "step"):
        self.phase = phase
        self.rows: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.suspended = 0
        self._hooks = []
        self._mode = _CountingMode(self)

    # ---------------------------------------------------------------- rows
    def charge(self, name: str, flops: float, nbytes: float, major: bool) -> None:
        row = _row(self.rows.setdefault(self.phase, {}), name, major)
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        if major:
            row["fused_bytes"] += nbytes

    def count_op(self, func, args, kwargs, out) -> None:
        """Charge one aten op (module docstring)."""
        results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not results:
            return
        packet = func.overloadpacket
        if (packet.__name__ in ("_to_copy", "copy_") and isinstance(args[0], torch.Tensor)
                and args[0].device != results[0].device):
            return
        nbytes = sum(_nbytes(t) for t in results) + sum(
            _nbytes(t) for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor))
        flop_fn = _flop_registry().get(packet)
        flops = float(flop_fn(*args, **kwargs, out_val=out)) if flop_fn is not None else 0.0
        short = packet.__name__.rstrip("_")
        major = short in _MAJOR or (short == "copy" and args[0]._is_view())
        self.charge(f"aten.{packet.__name__}", flops, nbytes, major)

    # --------------------------------------------------------- optimizers
    def _optimizer_pre(self, opt, args, kwargs):
        self.suspended += 1

    def _optimizer_post(self, opt, args, kwargs):
        self.suspended -= 1
        if self.suspended:
            return
        nbytes = 0
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                states = [t for t in opt.state.get(p, {}).values()
                          if isinstance(t, torch.Tensor) and t.numel() == p.numel()]
                # read: the parameter, its gradient, its states; written:
                # the parameter and its states
                nbytes += _nbytes(p) * 2 + _nbytes(p.grad) + 2 * sum(_nbytes(t) for t in states)
        self.charge(f"optimizer:{type(opt).__name__}", 0.0, float(nbytes), major=True)

    # ------------------------------------------------------------- context
    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("an OpCounter is already active in this process")
        from torch.optim.optimizer import (
            register_optimizer_step_post_hook,
            register_optimizer_step_pre_hook,
        )

        self._hooks = [register_optimizer_step_pre_hook(self._optimizer_pre),
                       register_optimizer_step_post_hook(self._optimizer_post)]
        _ACTIVE = self
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        try:
            self._mode.__exit__(*exc)
        finally:
            _ACTIVE = None
            for h in self._hooks:
                h.remove()
            self._hooks = []

    # ------------------------------------------------------------ summary
    def totals(self, phase: Optional[str] = None) -> Dict[str, float]:
        """{"flops", "raw_bytes", "fused_bytes"} of one phase, or of all."""
        phases = [phase] if phase is not None else list(self.rows)
        rows = [r for ph in phases for r in self.rows.get(ph, {}).values()]
        return {"flops": sum(r["flops"] for r in rows),
                "raw_bytes": sum(r["bytes"] for r in rows),
                "fused_bytes": sum(r["fused_bytes"] for r in rows)}

    def kernel_rows(self) -> Dict[str, Dict[str, float]]:
        """{kernel: {"count", "flops", "bytes"}} of every phase, summed."""
        rows = self.merged_rows()
        return {name.split(":", 1)[1]: {k: rows[name][k] for k in ("count", "flops", "bytes")}
                for name in sorted(rows) if name.startswith("kernel:")}

    def merged_rows(self) -> Dict[str, Dict[str, Any]]:
        """Every phase's rows summed by name."""
        out: Dict[str, Dict[str, Any]] = {}
        for rows in self.rows.values():
            for name, r in rows.items():
                agg = _row(out, name, r["fused"])
                for k in ("count", "flops", "bytes", "fused_bytes"):
                    agg[k] += r[k]
        return out


def _flop_registry():
    from torch.utils.flop_counter import flop_registry

    return flop_registry
