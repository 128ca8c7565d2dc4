"""Dry-run cells: (architecture x input shape x mesh) -> a step traced on
fake tensors and counted.

The port of ``repro.launch.cells``.  For each cell of the assigned
40-cell grid it builds the step function (``train_step`` for train
shapes, ``prefill`` / ``decode_step`` for inference shapes) and one
rank's arguments on the meta device (:func:`train_cell`,
:func:`prefill_cell`, :func:`decode_cell`), and :func:`run_cell` runs
the step once on fake tensors (``FakeTensorMode``: no allocation, no
device) in the place of XLA's lower-and-compile, and reads:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``
  (matrix products and convolutions only), plus each traced kernel
  launch's operation count (:func:`repro_torch.kernels.profiling.
  dry_launches`: the counter cannot see a CUDA kernel's products);
* ``bytes_per_device``: each operation's input and output bytes summed
  over the step (views and metadata queries move nothing), plus each
  kernel launch's operand
  bytes: an unfused count, like XLA's "bytes accessed" of an unfused
  graph, far above what the card moves where operations would fuse;
* ``argument_bytes`` / ``output_bytes``: the bytes of the arguments (this
  rank's blocks) and of the outputs (each storage once);
* ``temp_bytes``: the peak of the live storage the step allocated, on
  top of the arguments;
* ``collective_bytes``: by kind, the bytes each collective call of the
  port would move (:func:`repro_torch.distributed.sharded.simulate`: an
  all-gather its result, an all-reduce its operand), recorded at the
  port's own call sites (the parameter gathers, the gradient reduction,
  the MoE's counts); no group runs;
* ``scan_length``: the reference's scan steps; ``num_while_loops`` is 0
  (the port's layers are a Python loop); ``compile_seconds`` the trace's
  seconds.

The step is the port's as it is, on the card's route (B8 and B9 traced
as launches): the sharded train step gathers the whole weights on every
rank and ranks that differ only on ``model`` compute the same rows, so
FLOPs and temps per device are far above the reference's
tensor-parallel figures and many full-width cells do not fit 80 GB; the
serving cells run ``prefill`` / ``decode_step`` over the rank's rows and
cache blocks with whole weights (the port serves unsharded).  A cell
that does not fit says so by its bytes.

The reference's HLO parsers (``collective_bytes_from_hlo``,
``while_trip_counts``) have no counterpart: the port has no HLO.

Shape grid (assignment):
  train_4k     seq 4096   global_batch 256   -> train_step
  prefill_32k  seq 32768  global_batch 32    -> prefill
  decode_32k   seq 32768  global_batch 128   -> decode_step (1 new token)
  long_500k    seq 524288 global_batch 1     -> decode_step, SSM/hybrid only
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (
    ARCH_IDS,
    ModelConfig,
    TrainConfig,
    get_config,
)
from repro_torch.distributed import sharded
from repro_torch.distributed.shardings import (
    batch_shardings,
    cache_shardings,
    entry_axes,
    guard,
    train_state_shardings,
)
from repro_torch.kernels import profiling
from repro_torch.models.lm import (
    _num_steps,
    decode_step,
    init_params,
    make_decode_cache,
    prefill,
)
from repro_torch.train.train_step import build_train_step, init_train_state
from repro_torch.train.tree import leaves_with_path, tree_map

__all__ = [
    "BEST_CONFIG",
    "CellResult",
    "DEFAULT_BEST",
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "all_cells",
    "best_config",
    "calibrate_cell",
    "cell_is_skipped",
    "decode_cell",
    "prefill_cell",
    "run_cell",
    "train_cell",
]

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# long_500k requires sub-quadratic attention: runs only for SSM/hybrid.
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "hymba-1.5b")

# The reference's per-arch best configuration (its §Perf hillclimb).
BEST_CONFIG = {
    ("command-r-plus-104b", "train"): dict(layout="fsdp", remat="full"),
}
DEFAULT_BEST = dict(layout="tp_sp", remat="full")


def best_config(arch: str, shape: Optional[str] = None,
                num_chips: int = 256):
    kind = SHAPES[shape]["kind"] if shape in SHAPES else None
    bc = BEST_CONFIG.get((arch, kind), DEFAULT_BEST)
    if bc["layout"] == "fsdp" and shape in SHAPES \
            and SHAPES[shape]["global_batch"] < num_chips:
        # pure ZeRO-3 needs batch >= chips; below that the model axis
        # would recompute every token redundantly: fall back to tp_sp
        return DEFAULT_BEST
    return bc


def cell_is_skipped(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return (
            "long_500k needs sub-quadratic attention; "
            f"{arch} is a full-attention arch (DESIGN.md §6)"
        )
    return None


def all_cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape


# ---------------------------------------------------------------------------
# one rank's arguments on the meta device
# ---------------------------------------------------------------------------
def _blocks(tree: Any, specs: Any, mesh) -> Any:
    """Rank 0's block of every meta leaf."""
    with sharded.simulate(mesh):
        return sharded.local_blocks(tree, specs, mesh)


def _rows(leaf: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's rows of a batch leaf (the whole of it where the data axes
    do not divide it)."""
    spec = batch_shardings(mesh, {"x": leaf})["x"]
    return _blocks(leaf, guard(spec, leaf.shape, mesh), mesh)


def _prefix(cfg: ModelConfig, rows: int) -> Optional[torch.Tensor]:
    if not cfg.frontend:
        return None
    return torch.empty((rows, cfg.frontend_tokens, cfg.d_model),
                       dtype=torch.float32, device="meta")


def default_train_config(cfg: ModelConfig, seq_len: int, global_batch: int,
                         remat_policy: str = "minimal",
                         microbatches: int = 1) -> TrainConfig:
    """The reference's dry-run train config of a cell."""
    return TrainConfig(
        seq_len=seq_len, global_batch=global_batch,
        remat_policy=remat_policy, microbatches=microbatches,
        optimizer_state_dtype=(
            "bfloat16" if cfg.num_params() > 2e11 else "float32"),
        loss_chunk=(512 if (cfg.padded_vocab >= 65536
                            and cfg.num_params() > 5e10) else 0),
    )


def train_cell(cfg: ModelConfig, mesh, seq_len: int, global_batch: int,
               tc: Optional[TrainConfig] = None, layout: str = "tp_sp"):
    """``(fn, (state, batch), tc)``: the sharded train step and rank 0's
    blocks of the train state (by ``train_state_shardings``) and its rows
    of the batch (by ``batch_shardings``), on the meta device."""
    tc = tc or default_train_config(cfg, seq_len, global_batch)
    whole = init_train_state(cfg, tc, device="meta")
    specs = train_state_shardings(mesh, whole, layout)
    state = _blocks(whole, specs, mesh)
    # each micro-batch's rows over the data axes, as launch/train.py cuts
    # them (a micro-batch they do not divide goes whole to every rank)
    micro = (global_batch // tc.microbatches, seq_len)
    like = torch.empty(micro, device="meta")
    spec = guard(batch_shardings(mesh, {"t": like}, layout)["t"], micro,
                 mesh)
    axes = entry_axes(spec[0])
    rows = global_batch // math.prod(mesh.shape[a] for a in axes)
    batch = {"tokens": torch.empty((rows, seq_len), dtype=torch.int32,
                                   device="meta")}
    prefix = _prefix(cfg, rows)
    if prefix is not None:
        batch["prefix"] = prefix
    fn = build_train_step(cfg, tc, mesh=mesh, param_specs=specs.params,
                          batch_axes=axes)
    return fn, (state, batch), tc


def prefill_cell(cfg: ModelConfig, mesh, seq_len: int, global_batch: int):
    """``(fn, args)``: ``prefill`` into a cache of ``seq_len`` slots over
    rank 0's rows, with the whole weights."""
    f = cfg.frontend_tokens if cfg.frontend else 0
    tokens = _rows(torch.empty((global_batch, seq_len - f),
                               dtype=torch.int32, device="meta"), mesh)
    params = init_params(cfg, device="meta")

    def fn(params, tokens, prefix=None):
        return prefill(cfg, params, tokens, cache_len=seq_len,
                       prefix_embeddings=prefix)

    prefix = _prefix(cfg, tokens.shape[0])
    return fn, (params, tokens) + ((prefix,) if prefix is not None else ())


def decode_cell(cfg: ModelConfig, mesh, seq_len: int, global_batch: int):
    """``(fn, args)``: one ``decode_step`` over rank 0's rows and cache
    blocks (batch over the data axes, sequence over ``model``), with the
    whole weights, writing the block's last slot."""
    params = init_params(cfg, device="meta")
    whole = make_decode_cache(cfg, global_batch, seq_len, torch.bfloat16,
                              device="meta")
    cache = _blocks(whole, cache_shardings(mesh, whole), mesh)
    token = _rows(torch.empty((global_batch,), dtype=torch.int32,
                              device="meta"), mesh)
    if "k" in cache:
        slots = cache["k"].shape[3]
    elif "latent" in cache:
        slots = cache["latent"].shape[2]
    else:
        slots = seq_len
    pos = slots - 1

    def fn(params, token, cache):
        return decode_step(cfg, params, token, cache, pos)

    return fn, (params, token, cache)


# ---------------------------------------------------------------------------
# the trace: FLOPs, bytes, live storage
# ---------------------------------------------------------------------------
def _tensors(tree) -> list:
    return [t for _, t in leaves_with_path(tree)
            if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _trace_mode():
    """A dispatch mode that sums each operation's input and output bytes
    and keeps the peak of the live storage it saw allocated."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Trace(TorchDispatchMode):
        def __init__(self, args):
            super().__init__()
            self.bytes = 0.0
            self.live = 0
            self.peak = 0
            self.known = {t.untyped_storage()._cdata for t in args}

        def _track(self, t: torch.Tensor) -> None:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                return
            n = st.nbytes()
            self.known.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)

            def freed(key=key, n=n):
                self.known.discard(key)
                self.live -= n

            weakref.finalize(st, freed)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = _tensors(out)
            # a view or a query of metadata (prim.device) moves nothing
            if outs and not func.is_view:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in _tensors((args, kwargs)) + outs)
            for t in outs:
                self._track(t)
            return out

    return Trace


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh_desc: str
    flops_per_device: float
    bytes_per_device: float
    argument_bytes: float
    output_bytes: float
    temp_bytes: float
    collective_bytes: Dict[str, float]
    num_while_loops: int
    scan_length: int
    compile_seconds: float
    skipped: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def trace(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once on fake tensors of the meta ``args``' shapes
    and dtypes (on the CPU device, on the card's kernel route) and count
    it: ``{"flops", "bytes", "argument_bytes", "output_bytes",
    "temp_bytes", "kernels" (launches by name), "seconds"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode(), profiling.dry_launches() as dry:
        fake = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), args)
        mode = _trace_mode()(_tensors(fake))
        counter = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with counter, mode:
            out = fn(*fake)
        seconds = time.perf_counter() - t0
        return {
            "flops": float(counter.get_total_flops() + dry.flops),
            "bytes": float(mode.bytes + dry.bytes),
            "argument_bytes": float(_storage_bytes(_tensors(fake))),
            "output_bytes": float(_storage_bytes(_tensors(out))),
            "temp_bytes": float(mode.peak),
            "kernels": dict(dry.launches),
            "seconds": seconds,
        }


def run_cell(arch: str, shape: str, mesh, mesh_desc: str,
             remat_policy: str = "minimal",
             microbatches: int = 1,
             layers_override: Optional[int] = None,
             layout: str = "tp_sp",
             spec: Optional[Dict[str, Any]] = None) -> CellResult:
    """One cell on ``mesh`` (a mesh with no group: the meta production
    mesh); ``spec`` (``{"kind", "seq_len", "global_batch"}``) replaces
    ``SHAPES[shape]`` for a shape off the grid."""
    skip = cell_is_skipped(arch, shape)
    if skip:
        return CellResult(
            arch=arch, shape=shape, mesh_desc=mesh_desc,
            flops_per_device=0, bytes_per_device=0, argument_bytes=0,
            output_bytes=0, temp_bytes=0, collective_bytes={},
            num_while_loops=0, scan_length=0, compile_seconds=0,
            skipped=skip,
        )
    cfg = get_config(arch)
    if layers_override is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers_override)
    spec = spec or SHAPES[shape]
    seq, gb = spec["seq_len"], spec["global_batch"]
    if spec["kind"] == "train":
        tc = default_train_config(cfg, seq, gb, remat_policy, microbatches)
        fn, args, _ = train_cell(cfg, mesh, seq, gb, tc=tc, layout=layout)
    elif spec["kind"] == "prefill":
        fn, args = prefill_cell(cfg, mesh, seq, gb)
    else:
        fn, args = decode_cell(cfg, mesh, seq, gb)
    with sharded.simulate(mesh) as collectives:
        counted = trace(fn, args)
    return CellResult(
        arch=arch, shape=shape, mesh_desc=mesh_desc,
        flops_per_device=counted["flops"],
        bytes_per_device=counted["bytes"],
        argument_bytes=counted["argument_bytes"],
        output_bytes=counted["output_bytes"],
        temp_bytes=counted["temp_bytes"],
        collective_bytes=dict(collectives),
        num_while_loops=0,
        scan_length=_num_steps(cfg),
        compile_seconds=counted["seconds"],
    )


# ---------------------------------------------------------------------------
# Calibration: per-layer FLOPs / bytes / collectives from 2 and 4 layers
# ---------------------------------------------------------------------------
def calibrate_cell(arch: str, shape: str, mesh, mesh_desc: str,
                   remat_policy: str = "minimal",
                   microbatches: int = 1,
                   layout: str = "tp_sp") -> Dict[str, Any]:
    """The reference's calibration: the cell at 2 and 4 layers (a period-2
    model 4 and 8), ``F(L) = once + L * per_layer`` solved and taken to
    the production depth.  XLA counts a scanned layer once, which is why
    the reference needs it; the port counts every layer, so the
    extrapolation reproduces :func:`run_cell`'s full-depth count."""
    cfg = get_config(arch)
    period = 2 if (cfg.uses_moe and cfg.moe_layer_period == 2) else 1
    l_small, l_big = 2 * period, 4 * period

    res = {}
    for lo in (l_small, l_big):
        res[lo] = run_cell(
            arch, shape, mesh, mesh_desc,
            remat_policy=remat_policy,
            microbatches=microbatches,
            layers_override=lo,
            layout=layout,
        )

    dl = l_big - l_small
    per_layer_flops = (res[l_big].flops_per_device
                       - res[l_small].flops_per_device) / dl
    per_layer_bytes = (res[l_big].bytes_per_device
                       - res[l_small].bytes_per_device) / dl
    once_flops = res[l_small].flops_per_device - l_small * per_layer_flops
    once_bytes = res[l_small].bytes_per_device - l_small * per_layer_bytes

    coll_kinds = set(res[l_small].collective_bytes) | set(
        res[l_big].collective_bytes)
    per_layer_coll, once_coll = {}, {}
    for kind in coll_kinds:
        a = res[l_small].collective_bytes.get(kind, 0.0)
        b = res[l_big].collective_bytes.get(kind, 0.0)
        per_layer_coll[kind] = (b - a) / dl
        once_coll[kind] = a - l_small * per_layer_coll[kind]

    L = cfg.num_layers
    return {
        "arch": arch,
        "shape": shape,
        "mesh_desc": mesh_desc,
        "num_layers": L,
        "flops_per_device": once_flops + L * per_layer_flops,
        "bytes_per_device": once_bytes + L * per_layer_bytes,
        "collective_bytes": {
            k: once_coll[k] + L * per_layer_coll[k] for k in coll_kinds
        },
        "per_layer_flops": per_layer_flops,
        "once_flops": once_flops,
        "per_layer_bytes": per_layer_bytes,
        "once_bytes": once_bytes,
        "per_layer_collectives": per_layer_coll,
    }
