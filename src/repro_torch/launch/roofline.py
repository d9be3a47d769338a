"""Roofline terms for the card and the counts of a traced step (the JAX
package's ``launch/roofline.py``).

  compute term    = FLOPs / peak FLOP/s
  memory term     = HBM bytes / HBM bandwidth
  collective term = collective bytes / link bandwidth

Hardware model: one NVIDIA H100 SXM 80GB at its 700 W limit (the figures
``chip_smoke.py`` bounds every kernel by): 989 TFLOP/s dense bf16 on the
tensor cores, 3.35 TB/s of HBM3, and NVLink 4's 450 GB/s per direction in
place of the TPU's ICI link.  :data:`HBM_BYTES` is the card's memory as
``torch.cuda.get_device_properties(0).total_memory`` reads it.

The JAX module reads its per-device counts from a compiled XLA
executable.  Here :class:`StepTrace` counts them while the step runs
eagerly, on real tensors or on fake ones (``FakeTensorMode``: shapes and
dtypes, no storage, so a full-width step of any mesh traces on one
host): :func:`cost_summary` reads its FLOPs and bytes,
:func:`collective_bytes` its collectives and :func:`memory_summary` its
live bytes.  An eager step runs every layer and microbatch, so these
count the whole step, where XLA's ``cost_analysis`` counts a loop's body
once.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores, H100 SXM 80GB
HBM_BW = 3.35e12           # bytes/s, HBM3, H100 SXM 80GB
LINK_BW = 450e9            # bytes/s per direction, NVLink 4, H100 SXM
HBM_BYTES = 85_017_493_504  # total_memory, NVIDIA H100 80GB HBM3, 700.00 W

_COST_FACTOR = {
    "all-gather": 1.0,          # ring: (n-1)/n ≈ 1 of output bytes
    "reduce-scatter": 1.0,      # of input ≈ output·n … we see output; ~1
    "all-reduce": 2.0,          # RS + AG phases
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# the c10d ops the port's collectives issue (``distributed/comm.py``:
# ``all_reduce``, ``all_gather_into_tensor``, ``all_to_all_single``) →
# their kind; each takes its result buffer(s) as its first argument
_C10D_KIND = {
    "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather",
    "alltoall_base_": "all-to-all",
}

# ops that only allocate: they move no byte
_ALLOCATING = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}

Record = Tuple[str, str, Tuple[int, ...]]     # (kind, dtype, shape)

_DEVICE = torch.ops.prim.device.default


def roofline(flops: float, hbm_bytes: float, coll_bytes: float
             ) -> Dict[str, Any]:
    t_c = flops / PEAK_FLOPS
    t_m = hbm_bytes / HBM_BW
    t_x = coll_bytes / LINK_BW
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_x)
    terms["bottleneck"] = dom
    terms["roofline_s"] = bound
    terms["compute_fraction_of_roofline"] = t_c / bound if bound else 0.0
    return terms


def model_flops(n_active_params: float, tokens: float, kind: str) -> float:
    """6·N·D (train) / 2·N·D (inference)."""
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n_active_params * tokens


def sparse_matmul(m: int, n: int, k: int, *, executed_fraction: float = 1.0,
                  block_m: int = 128, block_n: int = 128,
                  dtype_bytes: int = 2, backend: str = "kernel",
                  step_overhead_s: float = 0.0) -> Dict[str, Any]:
    """Sparse-aware roofline terms for one (m, n, k) matmul: the
    autotuner's candidate scorer.

    Folds the predicted executed-step fraction
    (:func:`repro_torch.launch.costmodel.sparse_step_fraction`) into the
    FLOP term and, by backend, the HBM term:

    * ``backend="xla"`` — the dense arm (``torch.matmul``): full FLOPs, A
      streamed once per column block, B once per row block, C once;
    * ``backend="kernel"`` — K1/K3: a skipped step reads neither operand,
      so FLOPs *and* operand bytes scale by the executed fraction;
    * ``backend="kfused"`` — K2/K4: FLOPs scale by the (smaller)
      condensed fraction; operand bytes are charged dense, as the JAX
      package charges them.

    ``step_overhead_s`` charges a fixed cost per executed step: zero on
    the card, non-zero for the CPU's plain walks (one PyTorch step a
    schedule position).
    """
    mt = -(-m // block_m)
    nt = -(-n // block_n)
    frac = min(max(float(executed_fraction), 0.0), 1.0)
    flops = 2.0 * m * n * k
    a_bytes = m * k * nt * dtype_bytes       # A panel re-read per col block
    b_bytes = k * n * mt * dtype_bytes       # B panel re-read per row block
    c_bytes = m * n * dtype_bytes
    if backend == "xla":
        frac = 1.0
    elif backend == "kernel":
        a_bytes *= frac
        b_bytes *= frac
    flops *= frac
    hbm = a_bytes + b_bytes + c_bytes
    t_c = flops / PEAK_FLOPS
    t_m = hbm / HBM_BW
    t_o = 0.0 if backend == "xla" else (
        step_overhead_s * mt * nt * max(frac, 1e-9))
    predict = max(t_c, t_m) + t_o
    return {"flops": flops, "hbm_bytes": hbm,
            "arithmetic_intensity": flops / hbm if hbm else 0.0,
            "compute_s": t_c, "memory_s": t_m, "overhead_s": t_o,
            "predict_s": predict,
            "bound": "compute" if t_c >= t_m else "memory"}


# ---------------------------------------------------------------------------
# the counts of one traced step
# ---------------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _state_tensors(tree) -> List[torch.Tensor]:
    """``tree``'s tensors, a module's parameters and buffers and a
    dataclass's fields (a KV cache) among them."""
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out.extend(_state_tensors([getattr(x, f.name)
                                       for f in dataclasses.fields(x)]))
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _shape_bytes(dtype: str, shape: Tuple[int, ...]) -> int:
    """The bytes of one record's buffer: its elements times the size of
    ``dtype`` (a ``str(torch.dtype)``)."""
    n = 1
    for d in shape:
        n *= d
    return n * getattr(torch, dtype.removeprefix("torch.")).itemsize


class StepTrace(TorchDispatchMode):
    """The counts of one step, op by op, while it runs inside this mode:

    * ``flops``: ``FlopCounterMode``'s count of products and convolutions,
      its formulas (``flop_registry``) applied to each op that has one,
      without the mode itself: its module hooks make reference cycles
      that keep a step's tensors alive until the garbage collector runs.
      (It would first decompose an op it has no formula for: no such op
      on the port's paths holds a product.);
    * ``bytes``: for every ATen op but a view and an allocation, the bytes of
      its tensor inputs and outputs (each read once, each written once):
      the counterpart of XLA's "bytes accessed";
    * ``collectives``: one ``(kind, dtype, shape)`` record for each buffer
      of each collective issued (the c10d ops of :data:`_C10D_KIND`; a
      group of one issues none);
    * ``live``/``peak``: the bytes of the storages alive, each counted
      from the op that made it until it is freed (``weakref.finalize`` on
      the storage), starting from the arguments' (:meth:`add_arguments`).

    Enter it inside the ``FakeTensorMode`` of a fake trace."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: List[Record] = []
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self._sizes: Dict[int, int] = {}
        self._arguments: set = set()
        self._finalizers: List[weakref.finalize] = []

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._sizes:
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            self._finalizers.append(weakref.finalize(st, self._free, key))
        return key

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def add_arguments(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (a module's parameters
        and buffers) as the step's arguments (parameters, optimizer state,
        batch, caches)."""
        for t in _state_tensors(tree):
            key = self._track(t)
            if key not in self._arguments:
                self._arguments.add(key)
                self.argument_bytes += self._sizes[key]

    def set_outputs(self, tree) -> None:
        """Count the storages of the step's outputs; those of arguments
        (state updated in place) are its aliases."""
        seen = set()
        for t in _state_tensors(tree):
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            self.output_bytes += st.nbytes()
            if st._cdata in self._arguments:
                self.alias_bytes += st.nbytes()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        for f in self._finalizers:   # the step is over: stop counting frees
            f.detach()
        self._finalizers.clear()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE:     # a fake tensor's ``.device``: no work
            return func(*args, **kwargs)
        packet = func._overloadpacket
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d":
            kind = _C10D_KIND.get(name)
            if kind is not None:
                self.collectives.extend(
                    (kind, str(t.dtype), tuple(t.shape))
                    for t in _tensors(args[0]))
        if (func.namespace == "aten" and not func.is_view
                and name not in _ALLOCATING):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        for t in _tensors(out):
            self._track(t)
        return out


def collective_bytes(records: Iterable[Record]) -> Dict[str, float]:
    """Per-device collective payload bytes by kind (+ ``total``): each
    record's buffer bytes times its kind's ring factor."""
    out: Dict[str, float] = {k: 0.0 for k in _COST_FACTOR}
    for kind, dtype, shape in records:
        out[kind] += _shape_bytes(dtype, shape) * _COST_FACTOR[kind]
    out["total"] = sum(out[k] for k in _COST_FACTOR)
    return out


def cost_summary(trace: StepTrace, n_devices: int) -> Dict[str, float]:
    """FLOPs and bytes of one device's traced step (:class:`StepTrace`):
    ``flops_per_device`` is ``FlopCounterMode``'s count, products and
    convolutions only; ``bytes_per_device`` is the sum over every op but
    views and allocations of its tensor inputs' and outputs' bytes."""
    return {"flops_per_device": float(trace.flops),
            "bytes_per_device": float(trace.bytes),
            "n_devices": n_devices}


def memory_summary(trace: StepTrace) -> Dict[str, float]:
    """The JAX keys from one device's traced step: the arguments' bytes at
    entry, the outputs', the temporaries' (the peak of live bytes less the
    arguments and the outputs that are not arguments: what XLA's temp
    holds), the outputs that alias arguments (state updated in place,
    XLA's donation) and ``total_hbm_bytes`` by the JAX formula (the peak,
    unless outputs are made after it)."""
    arg, out = float(trace.argument_bytes), float(trace.output_bytes)
    alias = float(trace.alias_bytes)
    temp = max(trace.peak - arg - (out - alias), 0.0)
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "temp_size_in_bytes": temp, "alias_size_in_bytes": alias,
            "total_hbm_bytes": arg + out + temp - alias}
