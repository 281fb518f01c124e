"""Process groups and the tensor-parallel parameter layout (counterpart of
`etpnav_tpu/parallel/mesh.py`) over torch.distributed.

One process per device. The world is laid out as the JAX mesh's
`reshape(dp, mp)`: global rank r sits at dp slot r // mp and mp index
r % mp, so the mp group of a dp slot is consecutive ranks.

- 'dp': data parallel. A rank always holds its own batch (the
  DistributedSampler semantics of the reference, loader.py:127-149);
  the trainers sum the gradients over the dp group after backward and
  normalise each loss by the dp-global count (`Mesh.dp_sum`).
- 'mp': tensor parallel. `shard_params` splits the parameters the JAX
  package's rules split (`param_spec`, rewritten for the port's names
  and its (out, in) `Linear` layout) and records the layout on each
  split parameter (`TPSpec`, its `tp` attribute). The models see the
  mesh only through `parallel/tensor_parallel.py`'s autograd
  Functions, which read that record; the ranks of an mp group hold the
  same batch.

The collectives of the model and the trainers are all-reduce and
broadcast, which gloo also runs on CUDA tensors; a gather of shards is
an all-reduce of zero-padded copies (`gather_tensor`). Object
collectives (`all_gather_object`, `broadcast_object`) pickle into CPU
tensors under gloo and CUDA tensors under nccl, as torch.distributed's
object collectives do.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

#: seconds a collective may wait for a peer before it raises, so a rank
#: that dies does not leave the others blocked
TIMEOUT_S = 60

#: the per-dp-slot seed stride of the data and dropout streams (the JAX
#: pretrainer's per-process data seed, pretrain.py:393)
DP_SEED_STRIDE = 100003

# the rank's device, set by init_distributed
_DEVICE: List[torch.device] = []


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

def _launch_env() -> Optional[dict]:
    """(rank, world, local rank, init method) from torchrun's or SLURM's
    environment, or None when neither launched this process."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"]),
                "local_rank": int(env.get("LOCAL_RANK", env["RANK"])),
                "init_method": "env://"}
    if env.get("SLURM_NTASKS", "1") not in ("", "1"):
        for var in ("MASTER_ADDR", "MASTER_PORT"):
            if var not in env:
                raise RuntimeError(f"a SLURM job of {env['SLURM_NTASKS']} "
                                   f"tasks needs {var} in the environment")
        return {"rank": int(env["SLURM_PROCID"]),
                "world": int(env["SLURM_NTASKS"]),
                "local_rank": int(env.get("SLURM_LOCALID", 0)),
                "init_method": (f"tcp://{env['MASTER_ADDR']}:"
                                f"{env['MASTER_PORT']}")}
    return None


def launched_world() -> int:
    """The number of processes torchrun or SLURM launched (1 when neither
    did), read from the environment without starting anything."""
    launch = _launch_env()
    return 1 if launch is None else launch["world"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None) -> bool:
    """Start torch.distributed: from the arguments (`coordinator_address`
    "host:port", `num_processes`, `process_id`), else from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR/MASTER_PORT, LOCAL_RANK),
    else from SLURM's (SLURM_NTASKS, SLURM_PROCID, SLURM_LOCALID, with
    MASTER_ADDR/MASTER_PORT). When none of them is there it initialises
    nothing and returns False. Returns True when a world of more than one
    process is active afterwards.

    The rank's device is `device` when given, else cuda:LOCAL_RANK; a
    CUDA device that does not exist raises. `backend` is the caller's
    (MESH.backend), else nccl for a CUDA device and gloo for the CPU.
    Every collective times out after TIMEOUT_S seconds."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address or num_processes:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("init_distributed: coordinator_address, "
                             "num_processes and process_id go together")
        launch = {"rank": int(process_id), "world": int(num_processes),
                  "local_rank": int(process_id),
                  "init_method": f"tcp://{coordinator_address}"}
    else:
        launch = _launch_env()
        if launch is None:
            return False
    dev = (torch.device(device) if device is not None
           else torch.device("cuda", launch["local_rank"]))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"init_distributed: rank {launch['rank']} "
                               f"wants {dev}, and no CUDA device is present"
                               "; pass device='cpu' for a CPU rank")
        index = dev.index if dev.index is not None else 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"init_distributed: rank {launch['rank']} wants cuda:{index}"
                f", and this host has {torch.cuda.device_count()} CUDA "
                "device(s); name the device to share one")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=launch["init_method"],
        world_size=launch["world"], rank=launch["rank"],
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _DEVICE[:] = [dev]
    return dist.get_world_size() > 1


def rank_device(default="cuda") -> torch.device:
    """The device init_distributed gave this rank, else `default`."""
    return _DEVICE[0] if _DEVICE else torch.device(default)


def shutdown() -> None:
    """Leave the process group (a no-op when none is active)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE.clear()


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _object_device() -> torch.device:
    """Where small host values travel: the rank's CUDA device under nccl,
    the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """This rank's place in the dp x mp layout and its two groups (None
    for a group of one, whose collectives are the identity)."""

    dp: int
    mp: int
    dp_index: int
    mp_index: int
    dp_group: Any = None
    mp_group: Any = None

    @property
    def rank(self) -> int:
        return self.dp_index * self.mp + self.mp_index

    @property
    def mp_src(self) -> int:
        """The global rank of mp index 0 in this rank's mp group."""
        return self.dp_index * self.mp

    def dp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the dp group (a new tensor; no gradient)."""
        t = t.detach().clone()
        if self.dp_group is not None:
            dist.all_reduce(t, group=self.dp_group)
        return t

    def sync_grads(self, params: Sequence[torch.Tensor]) -> None:
        """The gradients of `params`, in place: summed over the dp group,
        then the unsplit ones made mp index 0's on every rank of its mp
        group. The mp peers compute the unsplit gradients from the same
        values, but a CUDA backward that adds with atomics (the embedding
        lookups') sums in another order on each; and each mp index sums
        over its own dp group, which need not give the same bits as
        another group's sum. Broadcasting after the sum leaves every
        replica with mp index 0's dp sum, one value in the world:
        replicas that part by an ulp never meet again."""
        self._all_reduce_grads(params)
        self._broadcast_replicated_grads(params)

    def _all_reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum the gradients over the dp group with one all-reduce of their
        flattened concatenation. A parameter without a gradient takes
        part as zeros and keeps no gradient."""
        if self.dp_group is None:
            return
        params = [p for p in params if p.requires_grad]
        if not params:
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.dp_group)
        off = 0
        for p, g in zip(params, grads):
            n = g.numel()
            if p.grad is not None:
                p.grad.copy_(flat[off:off + n].view_as(g))
            off += n

    def _broadcast_replicated_grads(self, params: Sequence[torch.Tensor]
                                    ) -> None:
        """The unsplit gradients of mp index 0, on its whole mp group,
        with one broadcast."""
        if self.mp_group is None:
            return
        ps = [p for p in params
              if p.grad is not None and not hasattr(p, "tp")]
        if not ps:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        dist.broadcast(flat, self.mp_src, group=self.mp_group)
        off = 0
        for p in ps:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
            off += p.numel()

    def broadcast_mp(self, obj):
        """`obj` of mp index 0, on every rank of its mp group."""
        if self.mp_group is None:
            return obj
        return broadcast_object(obj, self.mp_src, self.mp_group)


def make_mesh(dp: int = -1, mp: int = 1) -> Mesh:
    """The dp x mp layout of the world (one rank per device; dp = -1
    means world // mp). Without a process group, dp = mp = 1 is the only
    layout, and any other raises."""
    world = _world()
    if dp == -1:
        dp = world // mp
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ValueError(f"dp({dp}) * mp({mp}) != world size ({world}); "
                         "the port runs one process per device")
    if world == 1:
        return Mesh(1, 1, 0, 0)
    rank = dist.get_rank()
    mesh = Mesh(dp, mp, rank // mp, rank % mp)
    # every rank creates every group, in one order
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if d == mesh.dp_index and mp > 1:
            mesh.mp_group = g
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)])
        if m == mesh.mp_index and dp > 1:
            mesh.dp_group = g
    return mesh


# ---------------------------------------------------------------------------
# host-side collectives
# ---------------------------------------------------------------------------

def sync_max(values, group=None) -> list:
    """The elementwise max of small integer tuples over the world (the
    learn bucket every rank dispatches; the task-sync dist.broadcast
    analogue, loader.py:56-59). The identity on one process."""
    vals = [int(v) for v in values]
    if _world() == 1:
        return vals
    t = torch.tensor(vals, dtype=torch.int64, device=_object_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return [int(v) for v in t.tolist()]


def all_gather_object(obj, group=None) -> list:
    """Every rank's `obj`, in rank order; the objects may differ in
    structure (eval dicts keyed by each rank's own episodes). The
    identity list on one process (ss_trainer_ETP.py:727-738)."""
    if _world() == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, src: int, group=None):
    """`obj` of global rank `src`, on every rank of `group`."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group,
                               device=_object_device())
    return box[0]


#: elements per broadcast bucket of `broadcast_params`
_BUCKET = 1 << 25


def broadcast_params(module: nn.Module, src: int = 0) -> None:
    """Every floating-point parameter and buffer of `module` made global
    rank `src`'s, in place, in broadcasts of flattened buckets (DDP's
    initial broadcast)."""
    if _world() == 1:
        return
    ts = [t for t in list(module.parameters()) + list(module.buffers())
          if t.is_floating_point()]
    buckets, cur, n = [], [], 0
    for t in ts:
        if cur and (n + t.numel() > _BUCKET or t.dtype != cur[0].dtype):
            buckets.append(cur)
            cur, n = [], 0
        cur.append(t)
        n += t.numel()
    if cur:
        buckets.append(cur)
    with torch.no_grad():
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.broadcast(flat, src)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPSpec:
    """How a split parameter lies over its mp group: split on `dim` into
    `size` shards of `shard` entries (the last one zero-padded when
    `size` does not divide `full`, as GSPMD pads), this rank holding
    shard `index`."""

    dim: int
    full: int
    shard: int
    index: int
    size: int
    group: Any = None

    @property
    def start(self) -> int:
        return self.index * self.shard

    def __deepcopy__(self, memo):
        return self          # immutable, and a process group has no copy


# The JAX package's rules (parallel/mesh.py `_KERNEL_RULES`) on the port's
# dotted parameter names, as the dim of the port's tensor they split: a
# JAX column split P(None, "mp") of an (in, out) kernel is dim 0 of the
# port's (out, in) weight, a row split P("mp", None) is dim 1, and the
# vocabulary rows of the word embeddings and the MLM bias are dim 0.
_RULES = [
    # FFN: intermediate column-split, output row-split
    (re.compile(r"(^|\.)(ffn|visn_ffn|lang_ffn)\.intermediate\."
                r"(weight|bias)$"), 0),
    (re.compile(r"(^|\.)(ffn|visn_ffn|lang_ffn)\.output\.dense\.weight$"),
     1),
    (re.compile(r"(^|\.)linear1\.(weight|bias)$"), 0),
    (re.compile(r"(^|\.)linear2\.weight$"), 1),
    # attention: q, k, v column-split (heads), out row-split
    (re.compile(r"(^|\.)attn\.[qkv]\.(weight|bias)$"), 0),
    (re.compile(r"(^|\.)attn\.o\.weight$"), 1),
    (re.compile(r"(^|\.)out\.dense\.weight$"), 1),
    # the vocabulary-split embedding table and the MLM bias
    (re.compile(r"(^|\.)embeddings\.word_embeddings$"), 0),
    (re.compile(r"(^|\.)mlm_head\.bias$"), 0),
]


def param_spec(name: str) -> Optional[int]:
    """The dim the rules split the parameter `name` on (a dotted name of
    `named_parameters()`), or None (replicated)."""
    for rule, dim in _RULES:
        if rule.search(name):
            return dim
    return None


def _pad_to(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    if t.shape[dim] == n:
        return t
    pad = list(t.shape)
    pad[dim] = n - t.shape[dim]
    return torch.cat([t, t.new_zeros(pad)], dim)


def shard_of(full: torch.Tensor, spec: TPSpec) -> torch.Tensor:
    """This rank's shard of a full tensor (zero-padded at the end)."""
    padded = _pad_to(full, spec.dim, spec.shard * spec.size)
    return padded.narrow(spec.dim, spec.start, spec.shard).contiguous()


def gather_tensor(t: torch.Tensor, spec: TPSpec) -> torch.Tensor:
    """The full tensor of a shard: each rank places its shard in zeros of
    the padded full shape and the group sums them (an all-reduce, which
    every backend runs on CUDA tensors); the padding is cut off."""
    padded = list(t.shape)
    padded[spec.dim] = spec.shard * spec.size
    out = t.new_zeros(padded)
    out.narrow(spec.dim, spec.start, spec.shard).copy_(t)
    if spec.group is not None:
        dist.all_reduce(out, group=spec.group)
    return out.narrow(spec.dim, 0, spec.full)


def _heads_for(name: str, heads: Dict[str, int]) -> Optional[int]:
    best = None
    for prefix, n in heads.items():
        if prefix == "" or name == prefix or name.startswith(prefix + "."):
            if best is None or len(prefix) > len(best[0]):
                best = (prefix, n)
    return None if best is None else best[1]


def shard_params(mesh: Mesh, module: nn.Module,
                 heads: Dict[str, int]) -> nn.Module:
    """Replace every parameter of `module` that the rules split by this
    rank's mp shard, in place (the Parameter objects stay, so build the
    optimizer after this), and record its `TPSpec` as the parameter's
    `tp` attribute. `heads` maps a module-name prefix ("" for the whole
    module) to the head count of its attention stacks: mp must divide
    it, where GSPMD splits any dim, and a layout that does not raises,
    naming the stack. With mp = 1 nothing changes."""
    if mesh.mp == 1:
        return module
    for name, p in module.named_parameters():
        dim = param_spec(name)
        if dim is None:
            continue
        if re.search(r"attn\.[qkv]\.weight$", name):
            stack = name.rsplit(".", 2)[0]
            h = _heads_for(name, heads)
            if h is None:
                raise ValueError(f"shard_params: no head count given for "
                                 f"the attention stack {stack}")
            if h % mesh.mp:
                raise ValueError(f"shard_params: mp {mesh.mp} does not "
                                 f"divide the {h} heads of {stack}")
        full = p.shape[dim]
        spec = TPSpec(dim, full, -(-full // mesh.mp), mesh.mp_index,
                      mesh.mp, mesh.mp_group)
        with torch.no_grad():
            p.data = shard_of(p.data, spec)
        p.tp = spec
    return module


def full_shape(p: torch.Tensor) -> tuple:
    """The whole shape of a parameter that may be split."""
    spec = getattr(p, "tp", None)
    shape = list(p.shape)
    if spec is not None:
        shape[spec.dim] = spec.full
    return tuple(shape)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every split parameter gathered whole:
    the single-process layout. A collective: every rank of the mp group
    calls it."""
    sd = module.state_dict()
    for name, p in module.named_parameters():
        spec = getattr(p, "tp", None)
        if spec is not None:
            sd[name] = gather_tensor(p.detach(), spec)
    return sd


def load_full_state_dict(module: nn.Module,
                         sd: Dict[str, torch.Tensor]) -> None:
    """Load a single-process state dict into a module that may be split:
    each split parameter takes its shard."""
    sd = dict(sd)
    for name, p in module.named_parameters():
        spec = getattr(p, "tp", None)
        if spec is not None:
            sd[name] = shard_of(sd[name].to(p.device), spec)
    module.load_state_dict(sd)


@torch.no_grad()
def gather_into(full: nn.Module, split: nn.Module) -> None:
    """Copy a split module's values into a whole copy of it, in place."""
    for (name, p), q in zip(split.named_parameters(), full.parameters()):
        spec = getattr(p, "tp", None)
        q.copy_(gather_tensor(p, spec) if spec is not None else p)


def _optimizer_params(optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer) -> dict:
    """`optimizer.state_dict()` with every state tensor of a split
    parameter (Adam's moments, Lookahead's slow copy) gathered whole."""
    sd = optimizer.state_dict()
    state = dict(sd["state"])
    for i, p in enumerate(_optimizer_params(optimizer)):
        spec = getattr(p, "tp", None)
        if spec is None or i not in state:
            continue
        state[i] = {k: gather_tensor(v, spec)
                    if torch.is_tensor(v) and v.shape == p.shape else v
                    for k, v in state[i].items()}
    return {**sd, "state": state}


def load_full_optimizer_state(optimizer, sd: dict) -> None:
    """Load a single-process optimizer state into an optimizer over split
    parameters: each split parameter's state takes its shard."""
    state = dict(sd["state"])
    for i, p in enumerate(_optimizer_params(optimizer)):
        spec = getattr(p, "tp", None)
        if spec is None or i not in state:
            continue
        whole = full_shape(p)
        state[i] = {k: shard_of(v.to(p.device), spec)
                    if torch.is_tensor(v) and tuple(v.shape) == whole
                    else v for k, v in state[i].items()}
    optimizer.load_state_dict({**sd, "state": state})


def barrier() -> None:
    if _world() > 1:
        dist.barrier()


def is_writer() -> bool:
    """Global rank 0, which writes the checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0
