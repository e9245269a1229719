"""Trace cost model: FLOPs, bytes, collective bytes and memory of one
rank's step.

This module takes the place of the reference's ``roofline/hlo_cost.py``,
and has another name because it costs something else: that module parses
the HLO text of a program XLA compiled, and the port has no compiler and
no HLO. Here the step *runs* once, as one rank of the mesh would run it,
under ``FakeTensorMode`` (nothing is allocated or computed: every tensor
is a ``FakeTensor`` carrying only its shape, dtype and storage size),
inside ``TraceCost``, a ``TorchDispatchMode`` that sees every aten op the
rank runs. ``trace`` does both and returns the cost and the memory.

Counting rules, mirroring ``hlo_cost``:

* matmul, ``bmm``, the ``einsum``s lowered to them and convolutions count
  ``torch.utils.flop_counter``'s formulas (2·M·N·K);
* each output element of an elementwise or transcendental op in
  ``_ELEMENTWISE_1FLOP`` counts one FLOP, and each input element of a
  reduction in ``_REDUCE`` one (``hlo_cost``'s ``reduce``);
* views, reshapes, ``detach``, allocations and metadata ops move no bytes
  (``_ZERO_BYTE_OPS``, ``_PASSTHROUGH``); a read of selected rows
  (``_SLICE_READ``) moves twice its output and a write into part of a
  tensor (``_SLICE_WRITE``) twice its update, as ``hlo_cost`` charges a
  dynamic slice and a dynamic update slice; every other op moves its
  inputs plus its outputs. The port runs eagerly and unfused, so this is
  the traffic it really makes; against XLA's fused count, which keeps a
  fusion's internals in registers, it is an upper bound;
* collectives are recorded by ``distribution.sharding`` (on a traced
  mesh, where nothing is sent, and on real ranks alike) as operand bytes
  by ``hlo_cost``'s kind names, and their operands and outputs count as
  bytes too, as there.

Trip counts: Python loops (over layers, over chunks) unroll in the
trace, so every iteration counts as it runs. Where a loop's iterations
are identical, as the microbatches of a train step and the steps of a
recurrent scan are, the code iterates ``common.loops.trips(m)``: a
tracer that does not ``unroll`` installs its hook there
(``loops.collapsing``), and the loop runs one iteration whose cost
counts ``m`` times, as ``hlo_cost`` multiplies a ``while`` body by its
trip count; elsewhere it is ``range(m)``. A scan, whose iterations pass
a state on, iterates ``trips(m, carry=True)``: under the hook four
iterations, counting 1, ``m - 3``, 1 and
1 times, so that the first, a middle one (whose state a later one reads
and passes on), the last but one and the last each count as often as
their kind runs, in the backward too. The backward ops of the autograd
nodes made in an iteration count as that iteration does (by the nodes'
sequence numbers); a rematerialized forward (``torch.utils.checkpoint``,
run with grad enabled inside the backward) counts by the loops it runs
itself. ``loops.gathered`` joins a ``trips`` loop's per-iteration
outputs, a collapsed iteration's output standing for the iterations it
counts for.
FlopCounterMode, the cross-check, counts each traced op once.

Memory, the counterpart of ``compiled.memory_analysis()``: every storage
an op makes is followed by a weakref finalizer, so the live bytes are
known after each op. ``argument_bytes`` are the step's arguments (made
before the trace, under the same modes), ``output_bytes`` the step's
results that are not arguments (an output updated in place in an
argument counts with the arguments), ``temp_bytes`` the highest live
bytes during the step beyond both, and ``alias_bytes`` 0: nothing in the
port is donated. ``peak_bytes`` sums them as the reference's dry run
does. A microbatch traced for ``m`` is live once (its buffers are
replaced by the next one's); what the middle iteration of a scan leaves
alive at the loop's end (its outputs, the tensors saved for the
backward) is live ``m - 3`` times.

Labels: the port's models are functions over parameter trees, not
``nn.Module``s, so ``torch.utils.module_tracker`` would see no module
path; an op's label is the innermost frame of the port's code that
called it (``file:function``), a backward op's the same with ``bwd``,
plus the aten op.

No hand kernel runs in a trace: the kernel wrappers raise on a
``FakeTensor`` (``kernels/build.refuse_trace``), so a plain version is
never counted in a kernel's place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common import loops

_ELEMENTWISE_1FLOP = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg",
    "abs", "sign", "sgn", "floor", "ceil", "round", "trunc", "frac", "eq",
    "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "clamp", "clamp_min", "clamp_max", "remainder",
    "fmod", "atan2", "isfinite", "isnan", "isinf", "masked_fill", "lerp",
    "addcmul", "addcdiv", "reciprocal", "square",
}
# transcendentals and activations count 1 flop/elem too (hlo_cost's set)
_ELEMENTWISE_1FLOP |= {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "rsqrt", "sqrt", "pow", "sigmoid", "sin", "cos", "tan", "erf", "silu",
    "gelu", "relu", "softplus", "threshold_backward", "sigmoid_backward",
    "tanh_backward", "silu_backward", "gelu_backward", "softplus_backward",
}

#: one flop per input element (hlo_cost's reduce / reduce-window)
_REDUCE = {
    "sum", "mean", "amax", "amin", "prod", "logsumexp", "cumsum",
    "cumprod", "argmax", "argmin", "var", "std", "norm",
    "linalg_vector_norm", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "all", "any",
    "topk", "sort",
}
#: reductions with one tensor operand, elementwise with two
_MAX_MIN = {"max", "min"}

_ZERO_BYTE_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "_local_scalar_dense", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_has_compatible_shallow_copy_type", "set_",
}
#: views: no bytes move (hlo_cost's bitcast / reshape / get-tuple-element)
_PASSTHROUGH = {
    "view", "_unsafe_view", "_reshape_alias", "expand", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "alias", "detach", "slice",
    "select", "as_strided", "unbind", "split", "split_with_sizes",
    "chunk", "narrow", "view_as_real", "view_as_complex", "unfold",
    "diagonal", "_unsafe_split",
}
#: reads of selected rows: twice the output (hlo_cost's (dynamic-)slice)
_SLICE_READ = {"index_select", "gather", "index", "embedding", "take"}
#: writes into part of a tensor, and the argument index of the update:
#: twice the update (hlo_cost's dynamic-update-slice)
_SLICE_WRITE = {"copy_": 1, "index_put_": 2, "index_copy_": 3,
                "scatter_": 3, "scatter_add_": 3, "index_add_": 3,
                "masked_scatter_": 2, "_index_put_impl_": 2}

# ------------------------------------------------------------ cost model
@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    # attribution: {label: flops} / {label: bytes} for the breakdowns
    flops_by_label: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_label: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_label: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v * mult
        for k, v in other.flops_by_label.items():
            self.flops_by_label[k] = self.flops_by_label.get(k, 0.0) + v * mult
        for k, v in other.bytes_by_label.items():
            self.bytes_by_label[k] = self.bytes_by_label.get(k, 0.0) + v * mult
        for k, v in other.coll_by_label.items():
            self.coll_by_label[k] = self.coll_by_label.get(k, 0.0) + v * mult


def top_contributors(cost: Cost, n: int = 12) -> Dict[str, List]:
    fl = sorted(cost.flops_by_label.items(), key=lambda kv: -kv[1])[:n]
    by = sorted(cost.bytes_by_label.items(), key=lambda kv: -kv[1])[:n]
    return {"flops": fl, "bytes": by}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors in an op's (nested) arguments or results."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


_HERE = __file__
_LABELS: Dict[Any, str] = {}


def _frame_label(skip: str = "") -> str:
    """``file:function`` of the innermost frame of the port's code below
    the tracer (file relative to the package), past the files under
    ``skip``."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        lbl = _LABELS.get(code)
        if lbl is None:
            fn = code.co_filename
            i = fn.rfind("repro_torch/")
            lbl = "" if i < 0 or fn == _HERE else \
                f"{fn[i + 12:]}:{code.co_name}"
            _LABELS[code] = lbl
        if lbl and not (skip and lbl.startswith(skip)):
            return lbl
        f = f.f_back
    return "?"


class TraceCost(TorchDispatchMode):
    """Counts the cost (``.cost``) and follows the live bytes of every op
    dispatched under it (see the module docstring). Use inside a
    ``FakeTensorMode``; ``trace`` sets both up. ``unroll=True`` traces
    every iteration of ``trips`` loops."""

    def __init__(self, *, unroll: bool = False):
        super().__init__()
        self.unroll = unroll
        self.cost = Cost()
        self.live = 0
        self.peak = 0
        self._mult = 1.0
        #: id of every live storage -> the serial it was tracked under
        self._seen: Dict[int, int] = {}
        self._serial = 0
        self._prev = None
        #: [first, end, multiplier] of the autograd sequence numbers of
        #: the nodes each collapsed iteration made (end None: running)
        self._node_mults: List[list] = []
        #: storages made in the middle iteration of the innermost
        #: collapsed scan
        self._scan: Optional[Dict[int, tuple]] = None
        #: a storage's bytes counted beyond its own (a scan's survivors)
        self._extra: Dict[int, int] = {}

    # ---- trips and the recording interface of distribution.sharding
    def _collapsed(self, m: int, carry: bool):
        weights = (1, m - 3, 1, 1) if carry else (m,)
        outer, made = self._scan, {}
        try:
            for i, w in enumerate(weights):
                self._scan = made if carry and i == 1 else None
                self._mult *= w
                # open while the iteration runs: its own backward (a
                # microbatch's) runs inside it
                rng = [torch._C._autograd._get_sequence_nr(), None,
                       self._mult]
                self._node_mults.append(rng)
                try:
                    yield i
                finally:
                    rng[1] = torch._C._autograd._get_sequence_nr()
                    self._mult /= w
        finally:
            self._scan = outer
        # the middle iteration's survivors stand for m - 3 iterations' (a
        # storage's id may be reused once it is freed: match the serial)
        for key, (n, serial) in made.items():
            if self._seen.get(key) == serial:
                extra = (m - 4) * n
                self._extra[key] = self._extra.get(key, 0) + extra
                self.live += extra
        self.peak = max(self.peak, self.live)

    def _backward_mult(self, node) -> float:
        """The multiplier of the iteration that made ``node`` (the
        innermost: the last recorded range holding it)."""
        n = node._sequence_nr()
        for first, end, m in reversed(self._node_mults):
            if first <= n and (end is None or n < end):
                return m
        return 1.0

    def _weight(self):
        """(this op's multiplier, whether it runs in a backward)."""
        node = torch._C._current_autograd_node()
        backward = node is not None and not torch.is_grad_enabled()
        return (self._backward_mult(node) if backward else self._mult,
                backward)

    def add(self, kind: str, operand_bytes: int, output_bytes: int) -> None:
        """One collective (``sharding.recording``): operand bytes by kind,
        and operands plus outputs as bytes."""
        c, (w, _) = self.cost, self._weight()
        lbl = f"{kind}:{_frame_label('distribution/')}"
        c.coll_bytes += operand_bytes * w
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + \
            operand_bytes * w
        c.coll_by_label[lbl] = c.coll_by_label.get(lbl, 0.0) + \
            operand_bytes * w
        b = (operand_bytes + output_bytes) * w
        c.bytes += b
        c.bytes_by_label[lbl] = c.bytes_by_label.get(lbl, 0.0) + b

    def __enter__(self):
        from repro_torch.distribution import sharding
        self._hooks = contextlib.ExitStack()
        self._hooks.enter_context(sharding.recording(self))
        if not self.unroll:
            self._hooks.enter_context(loops.collapsing(self._collapsed))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hooks.__exit__(*exc)

    # ---- memory
    def _free(self, key: int, n: int) -> None:
        del self._seen[key]
        self.live -= n + self._extra.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        """Follow ``t``'s storage until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._serial += 1
        self._seen[key] = self._serial
        self.live += n
        if self._scan is not None:
            self._scan[key] = (n, self._serial)
        weakref.finalize(st, self._free, key, n)
        if self.live > self.peak:
            self.peak = self.live

    # ---- cost
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        name = func._overloadpacket.__name__
        for t in _tensors(out):
            self.track(t)
        base = name[:-1] if name.endswith("_") else name
        if base in _PASSTHROUGH or name in _ZERO_BYTE_OPS:
            return out
        w, backward = self._weight()
        flops = 0.0
        packet = func._overloadpacket
        if packet in _FLOP_REGISTRY:
            flops = float(_FLOP_REGISTRY[packet](*args, **kwargs,
                                                 out_val=out))
        elif base in _ELEMENTWISE_1FLOP:
            flops = float(sum(t.numel() for t in _tensors(out)))
        elif base in _REDUCE or base in _MAX_MIN:
            ins = [t for t in _tensors(args)]
            if base in _MAX_MIN and len(ins) > 1:
                flops = float(sum(t.numel() for t in _tensors(out)))
            elif ins:
                flops = float(ins[0].numel())
        if name in _SLICE_WRITE:
            upd = args[_SLICE_WRITE[name]] if len(args) > \
                _SLICE_WRITE[name] else None
            byts = 2.0 * _nbytes(upd) if isinstance(upd, torch.Tensor) \
                else 2.0 * sum(_nbytes(t) for t in _tensors(out))
        elif base in _SLICE_READ:
            byts = 2.0 * sum(_nbytes(t) for t in _tensors(out))
        else:
            byts = float(sum(_nbytes(t) for t in _tensors(args))
                         + sum(_nbytes(t) for t in _tensors(out)))
        c = self.cost
        lbl = _frame_label()
        if backward:
            lbl += " bwd"
        lbl = f"{lbl}/{name}"
        if flops:
            c.flops += flops * w
            c.flops_by_label[lbl] = c.flops_by_label.get(lbl, 0.0) + \
                flops * w
        c.bytes += byts * w
        c.bytes_by_label[lbl] = c.bytes_by_label.get(lbl, 0.0) + byts * w
        return out


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


_FLOP_REGISTRY = _flop_registry()


# ---------------------------------------------------------------- trace
@dataclasses.dataclass
class Traced:
    """One traced step: its ``Cost``, its memory (the reference's
    ``memory_analysis()`` fields and ``peak_bytes``), ``torch_flops``
    (``FlopCounterMode``'s own count: the matmuls and convolutions, the
    cross-check in the place of XLA's ``cost_analysis()``) and the step's
    outputs (FakeTensors)."""
    cost: Cost
    memory: Dict[str, int]
    torch_flops: float
    outputs: Any = None


def trace(fn: Callable, make_args: Callable[[], tuple], *,
          unroll: bool = False) -> Traced:
    """``fn(*make_args())`` traced under ``FakeTensorMode``: the
    arguments are made inside the modes (``torch.empty`` and the like
    give FakeTensors), then the step runs once under ``TraceCost`` and
    ``FlopCounterMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    tracer = TraceCost(unroll=unroll)
    with FakeTensorMode(), tracer:
        args = make_args()
        arg_storages = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                        for t in _tensors(args)}
        arg_bytes = sum(arg_storages.values())
        tracer.cost = Cost()
        base = tracer.peak = tracer.live
        flop_mode = FlopCounterMode(display=False)
        with flop_mode:
            out = fn(*args)
        out_storages = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                        for t in _tensors(out)}
        out_bytes = sum(n for k, n in out_storages.items()
                        if k not in arg_storages)
        # the live bytes at the start are the arguments (and whatever
        # making them left alive, counted with them)
        temp = max(0, tracer.peak - base - out_bytes)
    memory = {"argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
              "temp_bytes": int(temp), "alias_bytes": 0,
              "peak_bytes": int(temp + arg_bytes + out_bytes)}
    return Traced(tracer.cost, memory, float(flop_mode.get_total_flops()),
                  out)
