"""Device mesh for FHE sharding on ``torch.distributed``.

Port of ``lattisense_tpu/parallel/mesh.py``. Axis vocabulary:

- ``op``: graph-level sharding, independent ciphertext operations of a batch
  on different ranks (the reference's thread pool, FHE's data parallelism);
- ``limb``: kernel-level sharding of one ciphertext's RNS limbs, the key
  switch's digit products reduced with ``psum_scatter``
  (``parallel/keyswitch_sharded.py``);
- ``coeff``: kernel-level sharding of one polynomial's n coefficients, the
  NTT's transposes as ``all_to_all`` (``parallel/coeff_sharded.py``).

The JAX package is single-controller: one program places global arrays on a
``jax.sharding.Mesh`` and ``shard_map`` bodies see their shard. The port is
SPMD: one process a rank (``parallel/launch.py`` starts them), each computing
only its own shard, and ``Mesh`` is this rank's view of the
``(op, limb, coeff)`` grid, a ``torch.distributed`` ``DeviceMesh`` with those
dimension names. Rank r sits at ``((o·limb) + l)·coeff + c``.

Its collectives each act over one named axis, with JAX's tiled semantics:
``psum`` (all-reduce), ``psum_scatter`` (reduce-scatter along a dimension),
``all_gather`` (along a dimension) and ``all_to_all`` (split one dimension,
concatenate another, source-major). An axis of size 1 moves nothing: under
gloo its collectives return their input, under NCCL they are still issued (a
copy on the card), so that a one-rank world runs the NCCL calls. Sums are
int64 and wrap modulo 2^64, as the JAX package's uint64 sums do.

The backend is the process group's, chosen when the world starts: NCCL when
each rank owns a card, gloo when ranks share one card (NCCL refuses two ranks
on one device) and on the CPU. gloo computes on host memory, so a CUDA tensor
is copied to the host and back explicitly around each of its collectives;
``stats`` counts the calls and bytes of each collective (the bytes a rank
hands in) and every byte staged through the host, so that no copy is silent.
"""

import weakref

import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils import observability

AXES = ('op', 'limb', 'coeff')

# the tensor collectives' names: ``*_single`` from torch 2.13, the older
# names (the same signatures) before it
_REDUCE_SCATTER = getattr(dist, 'reduce_scatter_single', None) or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, 'all_gather_single', None) or dist.all_gather_into_tensor


def ct_batch_spec(limb_sharded: bool = False) -> tuple:
    """The partition of a batched ciphertext (B, degree+1, L, n): batch over
    ``op``, limbs over ``limb`` when ``limb_sharded``."""
    return ('op', None, 'limb' if limb_sharded else None, None)


def key_spec(limb_sharded: bool = False) -> tuple:
    """The partition of key-switch key halves (β, 2, L, n): replicated over
    ``op``, optionally limb-sharded."""
    return (None, None, 'limb' if limb_sharded else None, None)


class Mesh:
    """This rank's view of an ``op × limb × coeff`` mesh: its coordinates,
    one process group an axis, the device its tensors live on, the
    backend, and the counters of its collectives."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = dist.get_backend()
        self.shape = {a: device_mesh.size(i + 1) for i, a in enumerate(AXES)}
        self._index = {a: device_mesh.get_local_rank(a) for a in AXES}
        self._groups = {a: device_mesh.get_group(a) for a in AXES}
        self._recorder = None
        self.reset_stats()
        # the newest mesh's counters, read through a weak reference
        ref = weakref.ref(self)
        observability.register('collectives', lambda: ref().stats if ref() is not None else {})

    def _trivial(self, axis: str) -> bool:
        """An axis of one rank, whose collectives are identities; NCCL's are
        issued all the same."""
        return self.shape[axis] == 1 and self.backend != 'nccl'

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (JAX's ``axis_index``)."""
        return self._index[axis]

    def reset_stats(self):
        self.stats = {'staged_bytes': 0}

    def _count(self, name: str, t):
        entry = self.stats.setdefault(name, {'calls': 0, 'bytes': 0})
        entry['calls'] += 1
        entry['bytes'] += t.numel() * t.element_size()

    def _run(self, name: str, axis: str, x, out_shape, call):
        """``call(out, inp, group)`` on this axis's group, through host memory
        when gloo meets a CUDA tensor; → the output on x's device. While a
        task's CUDA graph is being captured (``_recorder`` set) the
        collective is not run but handed to the recorder, which ends the
        captured span there and runs the collective between replays."""
        x = x.contiguous()
        if self.backend == 'nccl' and not x.is_cuda:
            raise ValueError(f'{name}: the NCCL backend takes CUDA tensors, got {x.device}')
        group = self._groups[axis]

        def do(x):
            self._count(name, x)
            staged = self.backend == 'gloo' and x.is_cuda
            inp = x.cpu() if staged else x
            out = torch.empty(out_shape, dtype=x.dtype, device=inp.device)
            call(out, inp, group)
            if staged:
                self.stats['staged_bytes'] += (inp.numel() + out.numel()) * x.element_size()
                out = out.to(x.device)
            return out
        if self._recorder is not None:
            return self._recorder(do, x, out_shape)
        return do(x)

    # ---- collectives over one named axis ---------------------------------
    def psum(self, x, axis: str):
        """Sum of x over the ranks of ``axis``, on every one of them."""
        if self._trivial(axis):
            return x

        def call(out, inp, group):
            out.copy_(inp)
            dist.all_reduce(out, group=group)
        return self._run('psum', axis, x, x.shape, call)

    def psum_scatter(self, x, axis: str, dim: int):
        """Sum over ``axis``, each rank keeping its tile of ``dim`` (tile i
        to the rank at coordinate i)."""
        D = self.shape[axis]
        if self._trivial(axis):
            return x
        xm = x.movedim(dim, 0)
        if xm.shape[0] % D:
            raise ValueError(f'psum_scatter: dimension {dim} of {tuple(x.shape)} is not '
                             f'divisible by the {axis} axis ({D})')
        out = self._run('psum_scatter', axis, xm, (xm.shape[0] // D, *xm.shape[1:]),
                        lambda o, i, g: _REDUCE_SCATTER(o, i, group=g))
        return out.movedim(0, dim)

    def all_gather(self, x, axis: str, dim: int):
        """The ranks' x of ``axis`` concatenated along ``dim`` in coordinate
        order, on every rank."""
        D = self.shape[axis]
        if self._trivial(axis):
            return x
        xm = x.movedim(dim, 0)
        out = self._run('all_gather', axis, xm, (D * xm.shape[0], *xm.shape[1:]),
                        lambda o, i, g: _ALL_GATHER(o, i, group=g))
        return out.movedim(0, dim)

    def all_to_all(self, x, axis: str, split_dim: int, concat_dim: int):
        """JAX's tiled ``all_to_all``: ``split_dim`` cut into D tiles, tile j
        sent to the rank at coordinate j, the tiles received concatenated
        along ``concat_dim`` in source order."""
        D = self.shape[axis]
        if self._trivial(axis):
            return x
        split_dim %= x.dim()
        concat_dim %= x.dim()
        if x.shape[split_dim] % D:
            raise ValueError(f'all_to_all: dimension {split_dim} of {tuple(x.shape)} is not '
                             f'divisible by the {axis} axis ({D})')
        xs = x.unflatten(split_dim, (D, x.shape[split_dim] // D)).movedim(split_dim, 0)
        out = self._run('all_to_all', axis, xs, xs.shape,
                        lambda o, i, g: dist.all_to_all_single(o, i, group=g))
        return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)

    def barrier(self):
        dist.barrier(group=dist.group.WORLD)


def make_mesh(op: int | None = None, limb: int = 1, coeff: int = 1, device=None) -> Mesh:
    """This rank's ``Mesh`` over the world of the default process group
    (``parallel/launch.py`` starts it). ``op`` defaults to the world size over
    limb·coeff. A world k times the mesh's size holds k replicas of it (the
    JAX package's mesh over a subset of the devices): each rank computes in
    its replica and the replicas compute the same. The mesh's tensors live
    on ``device``, the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a torch.distributed world: start the ranks '
                           'with lattisense_torch.parallel.launch.run_ranks')
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if op is None:
        op = world // (limb * coeff)
    size = op * limb * coeff
    if size < 1 or world % size:
        raise ValueError(f'mesh {op}x{limb}x{coeff} does not divide the {world} ranks')
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, (world // size, op, limb, coeff),
                          mesh_dim_names=('replica',) + AXES)
    return Mesh(dm, dev)


def shard(mesh: Mesh, x, spec):
    """This rank's piece of the whole tensor x under ``spec`` (an axis name
    or None a dimension): each named dimension cut into equal tiles, the
    rank's coordinate picking its tile; on the mesh's device."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        D = mesh.shape[axis]
        if x.shape[dim] % D:
            raise ValueError(f'dimension {dim} of {tuple(x.shape)} is not divisible by the '
                             f'{axis} axis ({D})')
        k = x.shape[dim] // D
        x = x.narrow(dim, mesh.index(axis) * k, k)
    return x.contiguous().to(mesh.device)


def unshard(mesh: Mesh, x, spec):
    """The inverse of ``shard``: every named dimension all-gathered over its
    axis, the whole tensor on every rank."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = mesh.all_gather(x, axis, dim)
    return x
