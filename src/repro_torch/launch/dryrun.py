"""Multi-pod dry run: every (arch x shape x mesh) step of the LM paths on
the production meshes, run on shapes alone (counterpart of
``repro.launch.dryrun``).

The JAX package lowers and compiles each step on 512 placeholder host
devices and reads the compiled module's memory, cost and collectives.  The
port has no compiled module: one process impersonates a rank of the
production world -- a ``"fake"`` ``torch.distributed`` process group of 256
or 512 ranks (``torch.testing._internal.distributed.fake_pg``, whose
collectives return at once) -- and runs the rank's real step on fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and
dtypes, no storage), its parameters built from the specs
(``sharding.empty_sharded``), never drawn.  It records, for rank 0 and the
last rank:

* ``flops``: the aten ops' (``torch.utils.flop_counter.FlopCounterMode``)
  plus the hand-written kernels' work on the fake tensors, by kernel
  (``flash_attn.FAKE_FLOPS``, ``ssd_scan.FAKE_FLOPS``);
* ``memory``: the bytes of the step's arguments (parameters, optimizer
  state, inputs: exact, from their shapes), of its outputs, and the peak
  of the arguments plus the storages the step's ops hold at once;
* ``collectives``: the rank's calls and bytes by kind
  (``sharding.collectives.COLLECTIVES``), their ``count`` and ``bytes``, and
  ``world_bytes``, the rank's bytes times the world size (the reference's
  whole-module figure).

The tensors lie on ``cuda:0`` where PyTorch is built with CUDA, so every
kernel takes its CUDA route (its branch for fake tensors); a CPU-only
build cannot build an autograd graph over fake CUDA tensors, so there the
steps run on fake CPU tensors and the kernels' plain versions (``device``
in each record says which).  No card is needed either way.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both            # the 80 records

writes one JSON record a cell under ``--out`` (``results/dryrun_torch``); a
cell that fails is written with ``error`` and the exit code is 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.kernels import flash_attn, ssd_scan
from repro_torch.launch.mesh import LM_PRODUCTION, data_axes_of, make_lm_mesh
from repro_torch.nn import transformer as T
from repro_torch.obs import sink as obs
from repro_torch.sharding import collectives as C
from repro_torch.sharding import empty_sharded
from repro_torch.train import optimizer as opt
from repro_torch.train import step as ts

TRAIN_SHARDING = os.environ.get("REPRO_TRAIN_SHARDING", "tp_fsdp")
FAKE_KERNELS = (flash_attn, ssd_scan)


# ---------------------------------------------------------------------------
# skip table: long_500k needs sub-quadratic attention
# ---------------------------------------------------------------------------


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 524k dense KV decode is the quadratic "
                "regime this shape excludes (DESIGN.md)")
    if shape.name == "long_500k" and cfg.is_encdec:
        return "enc-dec audio arch: 30s/1500-frame context by construction"
    return None


def default_device() -> torch.device:
    """``cuda:0`` where PyTorch is built with CUDA, else the CPU (module
    docstring)."""
    return torch.device("cuda", 0) if torch.backends.cuda.is_built() \
        else torch.device("cpu")


# ---------------------------------------------------------------------------
# the step's inputs, on fake tensors
# ---------------------------------------------------------------------------


def shardings_for(cfg: ModelConfig, mesh, mode: str) -> T.Shardings:
    """The reference's choice for ``mode`` (train / prefill / decode).  Its
    ``shard_heads`` has no field here: the weights' specs decide which
    heads a rank runs (``fix_spec`` replicates q heads that do not divide
    over ``model``), so its ``shard_heads=True`` is the port's head-split
    weights or ``attn_seq_shard``, and ``False`` (decode of such heads,
    pure FSDP) is replicated ones or no tensor parallelism."""
    dp = data_axes_of(mesh)
    model_size = C.axis_size(mesh, "model")
    if mode == "train" and TRAIN_SHARDING == "fsdp":
        # pure FSDP: every axis is a batch axis, no tensor parallelism
        return T.Shardings(mesh=mesh, data_axes=tuple(mesh.mesh_dim_names),
                           model_axis="model", moe_ep=False)
    seq_shard = bool(cfg.n_heads) and cfg.n_heads % model_size != 0
    if mode == "decode":
        return T.Shardings(mesh=mesh, data_axes=dp, model_axis="model",
                           attn_seq_shard=False)
    return T.Shardings(mesh=mesh, data_axes=dp, model_axis="model",
                       attn_seq_shard=seq_shard)


def decode_capacity(cfg: ModelConfig, shape: InputShape, model_size: int
                    ) -> int:
    """The KV budget of a decode shape: its sequence (the sliding window's
    ring for long_500k), rounded down to a multiple of the model axis and
    at least one slot a rank (the reference's rule)."""
    capacity = shape.seq_len
    if cfg.sliding_window and shape.name == "long_500k":
        capacity = cfg.sliding_window       # the ring buffer is the window
    return max(model_size, (capacity // model_size) * model_size)


def input_specs(arch: Union[str, ModelConfig],
                shape_name: Union[str, InputShape], mesh,
                device: Optional[torch.device] = None) -> Tuple[str, tuple, Any]:
    """(kind, args, step callable) of a cell on ``mesh``: this rank's
    parameters (and optimizer state or decode state) as empty tensors of
    its blocks' shapes, the global batch, and the step the real run takes.
    Call it under ``FakeTensorMode`` for fake tensors."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    device = device or default_device()
    kind = shape.kind
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model

    def enc(dtype):
        return torch.empty((B, cfg.encoder.enc_len, d), dtype=dtype,
                           device=device) if cfg.is_encdec else None

    def tokens(s):
        return torch.zeros((B, s), dtype=torch.long, device=device)

    if kind == "train":
        sh = shardings_for(cfg, mesh, "train")
        fsdp = TRAIN_SHARDING == "fsdp"
        params = empty_sharded(cfg, sh, "train_fsdp" if fsdp else "train",
                               torch.float32, device, trainable=True)
        state = ts.init_train_state(params)
        batch = ts.TrainBatch(tokens=tokens(S), labels=tokens(S),
                              enc_input=enc(torch.float32))
        lr_fn = opt.cosine_schedule(3e-4, 100, 10_000)

        def fn(state, batch):
            return ts.train_step(state, batch, cfg, sh, lr_fn=lr_fn)

        return kind, (state, batch), fn

    if kind == "prefill":
        sh = shardings_for(cfg, mesh, "prefill")
        params = empty_sharded(cfg, sh, "serve", torch.bfloat16, device)

        def fn(params, tokens, enc_input):
            out = T.forward(params, tokens, cfg, sh, remat=False,
                            enc_input=enc_input)
            # serving prefill emits next-token logits
            return out.logits[:, -1]

        return kind, (params, tokens(S), enc(torch.bfloat16)), fn

    sh = shardings_for(cfg, mesh, "decode")
    params = empty_sharded(cfg, sh, "decode", torch.bfloat16, device)
    capacity = decode_capacity(cfg, shape, C.axis_size(mesh, "model"))
    with torch.no_grad():
        state = T.init_decode_state(params, cfg, B, capacity, sh=sh,
                                    enc_input=enc(torch.bfloat16))

    def fn(params, state, token):
        with torch.no_grad():
            return ts.serve_step(params, state, token, cfg, sh=sh)

    return kind, (params, state, tokens(1)), fn


# ---------------------------------------------------------------------------
# what a step holds and moves
# ---------------------------------------------------------------------------


def _storages(tree) -> Dict[int, int]:
    """{storage: bytes} of the tensors in ``tree`` (named tuples, dicts,
    lists and modules walked; each storage once): the same count for a
    fake run and a real one."""
    out: Dict[int, int] = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
        elif isinstance(x, torch.nn.Module):
            for t in x.parameters():
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages the ops under it create, while they live,
    and their peak: an op's output that aliases none of its inputs holds a
    new storage until the storage is freed."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.now = self.peak = 0

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage()._cdata
                for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.now += self.live[key]
            self.peak = max(self.peak, self.now)
            weakref.finalize(st, self._free, key)
        return out


def _reset_counts() -> None:
    C.reset_collectives()
    for mod in FAKE_KERNELS:
        for k in mod.FAKE_FLOPS:
            mod.FAKE_FLOPS[k] = 0


def collectives_record(world: int) -> Dict[str, Any]:
    """This rank's collectives by kind, their count and bytes, and the
    world's bytes (the rank's times the world size)."""
    rec: Dict[str, Any] = C.collectives()
    rec["count"] = sum(v["calls"] for v in rec.values())
    rec["bytes"] = sum(v["bytes"] for k, v in rec.items() if k != "count")
    rec["world_bytes"] = rec["bytes"] * world
    return rec


def measure(fn, args, world: int) -> Dict[str, Any]:
    """Run ``fn(*args)`` once (under ``FakeTensorMode`` for a dry run) and
    return its run_s, flops, memory and collectives."""
    arg = _storages(args)
    _reset_counts()
    flops = FlopCounterMode(display=False)
    live = LiveBytes()
    t0 = time.perf_counter()
    with flops, live:
        out = fn(*args)
    run_s = time.perf_counter() - t0
    kernels = {k: v for mod in FAKE_KERNELS
               for k, v in mod.FAKE_FLOPS.items() if v}
    aten = flops.get_total_flops()
    outs = {k: v for k, v in _storages(out).items() if k not in arg}
    return {
        "run_s": run_s,
        "flops": {"total": aten + sum(kernels.values()), "aten": aten,
                  "kernels": kernels},
        "memory": {"argument_bytes": sum(arg.values()),
                   "output_bytes": sum(outs.values()),
                   "temp_peak_bytes": live.peak,
                   "peak_bytes": sum(arg.values()) + live.peak},
        "collectives": collectives_record(world),
    }


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A ``"fake"`` process group of ``world`` ranks, this process rank
    ``rank``; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process with no process "
                           "group of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_rank(cfg: ModelConfig, shape: InputShape, dims: Tuple[int, ...],
             rank: int, device: Optional[torch.device] = None
             ) -> Dict[str, Any]:
    """One rank of a fake world laid out as the LM mesh ``dims`` ((data,
    model), or (pods, data, model)): the cell's step on fake tensors,
    measured (:func:`measure`), with its kind."""
    device = device or default_device()
    world = math.prod(dims)
    with fake_world(world, rank):
        mesh = make_lm_mesh(*dims[-2:], device.type,
                            pods=dims[0] if len(dims) == 3 else 1)
        with FakeTensorMode():
            kind, args, fn = input_specs(cfg, shape, mesh, device=device)
            rec = measure(fn, args, world)
    return {"rank": rank, "kind": kind, **rec}


def run_one(arch: str, shape_name: str, multi_pod: bool,
            layers: Optional[int] = None,
            device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The record of one cell: rank 0's step (and the last rank's, under
    ``last_rank``) on the production mesh, or the skip reason."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    dims = LM_PRODUCTION[multi_pod]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, dims)),
        "n_params": cfg.n_params(), "n_active": cfg.n_active_params(),
    }
    reason = skip_reason(cfg, shape)
    if reason:
        rec["skipped"] = reason
        return rec
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        rec["layers"] = layers
    device = device or default_device()
    first = run_rank(cfg, shape, dims, 0, device)
    last = run_rank(cfg, shape, dims, math.prod(dims) - 1, device)
    rec.update(kind=first.pop("kind"), device=f"{device} (fake)")
    last.pop("kind")
    rec.update(first)
    rec["last_rank"] = last
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(INPUT_SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh = "x".join(map(str, LM_PRODUCTION[mp]))
                tag = f"{arch}__{shape}__{mesh}"
                try:
                    rec = run_one(arch, shape, mp)
                    status = ("SKIP: " + rec["skipped"][:40]
                              if "skipped" in rec else
                              f"ok {rec['run_s']:.1f}s "
                              f"flops={rec['flops']['total']:.3g} peak="
                              f"{rec['memory']['peak_bytes'] / 1e9:.2f}GB "
                              f"collectives={rec['collectives']['count']}")
                except Exception as e:  # noqa: BLE001 -- report, continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "error": f"{type(e).__name__}: {e}"}
                    status = "FAIL " + rec["error"][:120]
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                obs.log(f"[dryrun] {tag}: {status}", component="dryrun",
                        tag=tag, status=status)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
