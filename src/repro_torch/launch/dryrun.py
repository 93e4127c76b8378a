"""Multi-node dry run: trace every (arch x shape x mesh) cell on a fake world.

Port of ``repro.launch.dryrun``.  The reference fakes 512 host devices,
lowers and compiles each cell's step onto the production mesh (single-pod
16 x 16 and multi-pod 2 x 16 x 16) and reads XLA's cost and memory
analyses.  The port has no compiler to ask.  It runs each cell's step once,
eagerly, as rank 0 of a world of the mesh's size:

  * the world is a *fake process group* (backend ``"fake"`` over a
    ``FakeStore``, from torch's private testing module
    ``torch.testing._internal.distributed.fake_pg``, imported in
    ``fake_world`` alone): every collective returns at once, with the
    shapes a real one would give;
  * the mesh is a ``DeviceMesh`` over device type ``"cpu"`` on that group,
    and every tensor is a fake tensor (``FakeTensorMode``): nothing is
    allocated and no kernel is launched, but every op that rank would run
    on its local shards is dispatched, with its shapes, placements and
    collectives.

This is the counterpart of the reference's host-platform devices, on which
its ops also take the plain XLA path; it is not a fallback.  On fake CPU
tensors the kernels' wrappers take their plain versions, as on any CPU
tensor, so the counts below are those versions' ops.

Inputs arrive already placed, as the reference's jit receives them: params,
AdamW moments (``count`` replicated), batch and cache are DTensors built by
``DTensor.from_local`` from fake local shards of the sanitized specs, so
placing them costs nothing and the collectives counted are the step's own.

``analyze`` gives the reference's record keys where the port has a
counterpart, read off the ops rank 0 runs on its local shards (one
``TorchDispatchMode`` under DTensor, ``_RankCounter``):

  * ``hlo_flops_per_chip``: the FLOPs of those local ops, by
    ``torch.utils.flop_counter``'s formulas (matmuls, attention,
    convolutions; elementwise ops count none).  A mode above DTensor would
    count the global op of every rank together; this one counts each
    rank's own work, replicated work in full on every rank;
  * ``hlo_bytes_per_chip``: each local op's inputs read once and outputs
    written once (eager: nothing is fused);
  * ``collectives``: result bytes and ``n_*`` counts of the
    ``_c10d_functional`` collectives by the reference's five kinds
    (``COLLECTIVE_OPS``; DTensor's all-to-all on a CPU group is the
    all-gather and chunk it issues), and of any other c10d op under its
    own name;
  * ``memory_analysis``: argument bytes (the inputs' local shards), output
    bytes, and temp bytes, the peak of live local storage above the
    arguments while the step runs.  ``generated_code_size_bytes`` is
    ``None``: an eager step generates no code;
  * the roofline terms against ``launch.mesh``'s H100 constants.  A
    collective on a mesh axis whose ranks lie within one node of
    ``GPUS_PER_NODE`` is divided by ``NVLINK_BW``, else by ``NIC_BW``;
    ``collective_links`` names the rate each axis took.  In the 16 x 16
    layout ``model`` holds 16 consecutive ranks, which span two nodes.

``with_layers`` and ``layer_unit`` are the reference's.  XLA counts a scan
body once, so the reference extrapolates from two depths; an eager step
runs every layer, so ``--layers`` here only shortens a trace.

Usage (a process of its own: the fake group becomes its default group,
and the CLI refuses a process that already has one):
  python -m repro_torch.launch.dryrun --arch tinyllama_1p1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import (GPUS_PER_NODE, HBM_BW, NIC_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, make_production_mesh)
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWState
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train.loop import TrainConfig, abstract_init, make_train_step
from repro_torch.tree import leaves

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# _c10d_functional op -> the reference's kind.
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_NOT_COUNTED = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree) -> list:
    # No closure that refers to itself: such a reference cycle would keep
    # each op's outputs alive until a garbage collection and inflate the
    # live-storage peak.
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    return sum(sh.local(t).numel() * sh.local(t).element_size()
               for t in _tensors(tree))


class _RankCounter(TorchDispatchMode):
    """Counts what one rank runs on its local shards: FLOPs, bytes read and
    written, collectives (bytes and counts by kind, each beside the mesh
    axis of its group) and live storage (current and peak).

    An op on DTensors is passed on (``NotImplemented``), so the mode sees
    the local ops DTensor runs for it.  Ops run under another fake mode
    than the one active on entry are DTensor's sharding propagation, not
    the rank's work, and are not counted."""

    def __init__(self, group_axes: dict):
        super().__init__()
        self.group_axes = group_axes
        self.flops = 0
        self.bytes = 0
        self.coll: dict[str, float] = {k: 0.0 for k in COLLECTIVE_OPS}
        self.n_coll: dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
        self.coll_by_axis: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()

        def freed(_, n=n):
            self.live -= n

        self._seen[st] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __enter__(self):
        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out
        packet = func._overloadpacket
        outs = _tensors(out)
        ns = packet._qualified_op_name.split("::")[0]
        name = packet.__name__
        if ns in ("_c10d_functional", "c10d") and name not in _NOT_COUNTED:
            kind = _KIND.get(name, name.rstrip("_"))
            nbytes = sum(t.numel() * t.element_size() for t in outs)
            self.coll[kind] = self.coll.get(kind, 0.0) + nbytes
            self.n_coll[kind] = self.n_coll.get(kind, 0) + 1
            group = next((a for a in list(args) + list(kwargs.values())
                          if isinstance(a, str) and a in self.group_axes), None)
            axis = self.group_axes.get(group, "?")
            self.coll_by_axis[axis] = self.coll_by_axis.get(axis, 0.0) + nbytes
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.bytes += sum(t.numel() * t.element_size()
                          for t in _tensors((args, kwargs)) + outs)
        if name not in _NOT_COUNTED:
            for t in outs:
                self.track(t)
        return out


def collective_bytes(counter: _RankCounter) -> dict[str, float]:
    """The reference's record of a step's collectives: result bytes and
    ``n_*`` counts by kind (the five of ``COLLECTIVE_OPS``, then any other
    c10d op under its own name)."""
    return {**counter.coll, **{f"n_{k}": v for k, v in counter.n_coll.items()}}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks as the default group,
    this process being rank 0; destroyed on exit.  Raises if a default
    group exists already."""
    # torch's private testing module: registers the "fake" backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: a default "
                           "process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_shard_sizes_off_fake():
    """DTensor sizes a strided shard (what a reshape that merges two
    sharded dims gives) from an index tensor that it makes under the
    ambient mode; under ``FakeTensorMode`` that tensor is fake, its
    ``tolist`` raises and the op's sharding propagation fails (torch 2.13),
    where real ranks run the op.  Inside this context the sizes are computed
    with the fake mode unset.  A torch without that method is left as it
    is."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def sizes(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    cls.local_shard_size_and_offset = sizes
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def axis_links(mesh: DeviceMesh) -> dict:
    """{axis: (bytes/s, "nvlink" or "nic")}: NVLink where the ranks of this
    rank's group on the axis lie within one node of ``GPUS_PER_NODE``."""
    out = {}
    for a in mesh.mesh_dim_names:
        ranks = mesh.mesh.movedim(mesh.mesh_dim_names.index(a), -1).reshape(
            -1, mesh.shape[mesh.mesh_dim_names.index(a)])
        ranks = next(r for r in ranks.tolist() if dist.get_rank() in r)
        one_node = len({r // GPUS_PER_NODE for r in ranks}) == 1
        out[a] = (NVLINK_BW, "nvlink") if one_node else (NIC_BW, "nic")
    return out


def with_layers(cfg, n: int):
    """Same architecture with a reduced layer count (the reference's
    two-point roofline extrapolation; an eager trace runs every layer, so
    here it only shortens the trace)."""
    changes: dict = {"num_layers": n}
    if cfg.family == "encdec":
        changes.update(encoder_layers=max(1, n // 2),
                       decoder_layers=max(1, n // 2))
    return dataclasses.replace(cfg, **changes)


def layer_unit(cfg) -> int:
    """Layer-count granularity that keeps the arch's group structure valid."""
    if cfg.attention == "local_global":
        return cfg.group_size
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.family == "encdec":
        return 2
    return 1


def _placed(meta: torch.Tensor, spec: P, mesh, dtype=None) -> DTensor:
    """A DTensor of ``meta``'s shape placed by ``spec`` on ``mesh``, from a
    fake local shard of rank 0 (``torch.chunk``'s first piece of each
    sharded dim): placing it costs no collective."""
    pl = sh.to_placements(spec, mesh)
    sizes = list(meta.shape)
    for p, n in zip(pl, mesh.shape):
        if p.is_shard():
            sizes[p.dim] = -(-sizes[p.dim] // n)
    stride = [1] * meta.ndim
    for d in range(meta.ndim - 2, -1, -1):
        stride[d] = stride[d + 1] * meta.shape[d + 1]
    return DTensor.from_local(torch.empty(sizes, dtype=dtype or meta.dtype), mesh,
                              pl, run_check=False, shape=meta.shape,
                              stride=tuple(stride))


def _place_tree(tree, specs, mesh, dtype=None):
    return sh._map(lambda s, t: _placed(t, s, mesh, dtype), specs, tree)


def trace_cell(arch: str, shape_name: str, mesh, *, fsdp: bool = True,
               microbatch: int = 1, layers: int | None = None):
    """The cell's step, its placed fake inputs and its metadata: returns
    ``(fn, args, meta)``; ``fn(*args)`` runs the step.  Call under a
    ``FakeTensorMode``."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = with_layers(cfg, layers)
    api = build_model(cfg, "cpu")
    shape = SHAPES[shape_name]
    specs = api.input_specs(shape)
    pshapes, axes = abstract_init(api)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind, "cfg": cfg}

    if shape.kind == "train":
        pspecs = sh.sanitize_tree(sh.param_specs(axes, mesh, cfg, fsdp=fsdp),
                                  pshapes, mesh)
        bspecs = sh.batch_specs(mesh, shape, cfg)
        in_b = sh.sanitize_tree({k: bspecs.get(k, P(sh.dp_axes(mesh), None))
                                 for k in specs}, specs, mesh)
        run = make_train_step(api, mesh, axes,
                              TrainConfig(microbatch=microbatch, fsdp=fsdp),
                              batch_spec=in_b)[1](specs)
        params = _place_tree(pshapes, pspecs, mesh)
        opt = AdamWState(_placed(torch.empty((), dtype=torch.int32), P(), mesh),
                         _place_tree(pshapes, pspecs, mesh, torch.float32),
                         _place_tree(pshapes, pspecs, mesh, torch.float32))
        batch = _place_tree(specs, in_b, mesh)
        return run, (params, opt, None, batch, torch.zeros((), dtype=torch.int32)), meta
    prefill_jit, decode_jit = make_serve_fns(api, mesh, axes, shape, pshapes)
    if shape.kind == "prefill":
        run = prefill_jit(specs)
        pspecs, bspecs = run.in_specs
        return run, (_place_tree(pshapes, pspecs, mesh),
                     _place_tree(specs, bspecs, mesh)), meta
    run = decode_jit(specs["cache"])
    pspecs, cspecs, tok_spec = run.in_specs
    return run, (_place_tree(pshapes, pspecs, mesh),
                 _place_tree(specs["cache"], cspecs, mesh),
                 torch.zeros((), dtype=torch.int32),
                 _placed(specs["token"], tok_spec, mesh)), meta


def analyze(counter: _RankCounter, mesh, links: dict, cfg, shape_name: str,
            args_bytes: int, out_bytes: int) -> dict:
    """The reference's record from one traced step (module docstring);
    ``links`` is ``axis_links(mesh)``."""
    nchips = mesh.size()
    coll = collective_bytes(counter)
    coll_total = sum(counter.coll.values())
    compute_s = counter.flops / PEAK_FLOPS_BF16
    memory_s = counter.bytes / HBM_BW
    collective_s = sum(b / links.get(a, (NIC_BW, "nic"))[0]
                       for a, b in counter.coll_by_axis.items())
    shape = SHAPES[shape_name]
    active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6 * active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * active * shape.global_batch
    flops = counter.flops
    return {
        "nchips": nchips,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": counter.bytes,
        "collective_bytes_per_chip": coll_total,
        "collectives": coll,
        "collective_bytes_by_axis": counter.coll_by_axis,
        "collective_links": {a: {"bytes_per_s": r, "link": k}
                             for a, (r, k) in links.items()},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": max(("compute", compute_s), ("memory", memory_s),
                        ("collective", collective_s), key=lambda t: t[1])[0],
        "model_flops_global": model_flops,
        "useful_flops_ratio": (model_flops / (flops * nchips) if flops else 0.0),
        "memory_analysis": {
            "argument_size_bytes": args_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": counter.peak - args_bytes,
            "generated_code_size_bytes": None,
        },
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str,
             *, fsdp: bool = True, microbatch: int = 1,
             verbose: bool = True, layers: int | None = None,
             mesh=None) -> dict:
    """Trace one cell on ``mesh`` (default: the production mesh of
    ``mesh_kind`` on the default group) and write its record; a failure is
    recorded as ``status: error`` with its traceback."""
    t0 = time.time()
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "status": "ok", "layers_override": layers,
                 "fsdp": fsdp, "microbatch": microbatch}
    try:
        mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                            device="cpu")
        kind = SHAPES[shape_name].kind
        cfg0 = get_config(arch)
        mode = ("decode" if kind == "decode"
                or (kind == "prefill" and not cfg0.pin_prefill) else "train")
        groups = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
        links = axis_links(mesh)
        with (FakeTensorMode(), sh.activation_sharding_scope(mesh, mode),
              _strided_shard_sizes_off_fake()):
            fn, args, meta = trace_cell(arch, shape_name, mesh, fsdp=fsdp,
                                        microbatch=microbatch, layers=layers)
            args_bytes = local_bytes(args)
            counter = _RankCounter(groups)
            for t in _tensors(args):
                counter.track(sh.local(t))
            # A first, uncounted run: DTensor plans each op there (its
            # sharding propagation runs fake ops at global shapes); the
            # counted run finds the plans in DTensor's caches.
            t_trace = time.time()
            fn(*args)
            rec["plan_s"] = round(time.time() - t_trace, 2)
            t_trace = time.time()
            with counter:
                out = fn(*args)
            rec["trace_s"] = round(time.time() - t_trace, 2)
            rec.update(analyze(counter, mesh, links, meta["cfg"], shape_name,
                               args_bytes, local_bytes(out)))
            del out
        if verbose:
            print(rec["memory_analysis"])
            print({"flops": rec["hlo_flops_per_chip"],
                   "bytes accessed": rec["hlo_bytes_per_chip"]})
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-40000:]
    os.makedirs(outdir, exist_ok=True)
    suffix = f"__L{layers}" if layers is not None else ""
    path = os.path.join(outdir, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    if verbose:
        dom = rec.get("dominant", "-")
        print(f"[{rec['status']}] {arch} x {shape_name} x {mesh_kind} "
              f"dominant={dom} ({time.time() - t0:.1f}s)")
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="override layer count (shortens the trace)")
    args = ap.parse_args()

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for sname, status in applicable_shapes(arch).items():
                if status == "run":
                    cells.append((arch, sname))
                else:
                    rec = {"arch": arch, "shape": sname, "status": "skipped",
                           "reason": status}
                    os.makedirs(args.out, exist_ok=True)
                    for mk in (["single", "multi"] if args.mesh == "both"
                               else [args.mesh]):
                        with open(os.path.join(
                                args.out, f"{arch}__{sname}__{mk}.json"), "w") as f:
                            json.dump(dict(rec, mesh=mk), f, indent=1)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for mk in meshes:
        with fake_world(512 if mk == "multi" else 256):
            for arch, sname in cells:
                rec = run_cell(arch, sname, mk, args.out,
                               fsdp=not args.no_fsdp,
                               microbatch=args.microbatch, layers=args.layers)
                failures += rec["status"] == "error"
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
