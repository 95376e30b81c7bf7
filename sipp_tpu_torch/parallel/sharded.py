"""Multi-device SIPP prover: cyclic index sharding over a 1-D mesh of cards
(port of sipp_tpu/parallel/sharded.py).

**Cyclic layout.**  Shard k of a d-shard mesh holds the global indices
{l*d + k} of A and B: arr.reshape(n/d, d, ...)[:, k].  A fold round pairs
i with i + n/2, and since d | n/2 until n == d, both fold partners and both
cross-product partners (A[n/2 + i], B[i]) lie on the same shard, at local
positions l and l + n/(2d).  So a round needs no communication but one
gather of each shard's two Fq12 partial Miller products.

**Per round, per shard**: one pair-mode K1 launch over the shard's local
(A_hi, B_lo) / (A_lo, B_hi) lanes (pairing/ate.py cross_miller), then the
mesh's gather of the (2, 2,3,2,16) partials onto the lead device, a product
tree over them in device order and one K2 launch at B = 2 there; after the
host transcript gives the challenge, one K3-G1 and one K3-G2 launch per
shard on its own card.  Every shard's launches are queued before the host
reads anything back, so distinct cards run at the same time.

**Deterministic bytes.**  Fq12 products are exact field operations and K2
writes canonical values, so any bracketing of the partials gives the bytes
of the single-device prover; the tree still runs in device order.

**Tail.**  Once n == d the shards are gathered onto the lead device and
protocol/prover.py's host rounds finish the proof (log2(d) rounds).

The Fiat-Shamir chain is replicated host state: the challenges depend only
on gathered public values, so every process computes them identically.  The
JAX module's precompile_round (an XLA ahead-of-time compile of the round
programs) has no counterpart: the kernels are built once per process by
ops/_build.py cuda_library.

A mesh spans the cards of one process, or, after launcher.initialize, every
process's cards in rank order; its one collective is Mesh.all_gather.
"""

import torch
import torch.distributed as dist

from ..fields import tower
from ..ops import fexp, fold, miller
from ..pairing import ate
from ..protocol import prover


class Mesh:
    """A 1-D mesh: `devices`, this process's shards' devices in mesh order
    (a device may repeat only where the caller names it so, as
    Mesh((cuda:0,) * 4)), and `group`, the torch.distributed process group
    whose ranks each hold as many shards (None: one process).  Shard
    `offset + j` of the `size` shards lives on devices[j]; devices[0] is
    the lead device, where gathered values land."""

    def __init__(self, devices, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("Mesh: no devices")
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.size = len(self.devices) * self.world
        self.offset = self.rank * len(self.devices)

    @property
    def lead(self):
        return self.devices[0]

    def all_gather(self, local):
        """This process's shard tensors (one per device, equal shapes) ->
        the list of all `size` shards' tensors on the lead device, in
        global shard order."""
        if len(local) != len(self.devices):
            raise ValueError(f"all_gather: {len(local)} tensors for {len(self.devices)} shards")
        parts = [t.to(self.lead) for t in local]
        if self.group is None:
            return parts
        mine = torch.stack(parts)
        bufs = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(bufs, mine, group=self.group)
        return [t for buf in bufs for t in buf.unbind(0)]


def make_mesh(num_devices: int = None, device="cuda") -> Mesh:
    """A mesh of num_devices shards (all visible cards when None).  On CUDA
    each shard has a card of its own, cuda:i, cuda:i+1, ... from the index
    that `device` names (0 for "cuda"; a named card alone when num_devices
    is None), and too few visible cards raise; device "cpu" gives
    num_devices (default 1) CPU shards.  After launcher.initialize,
    num_devices counts the shards of every process, each process takes
    num_devices / world of them (the same count on every rank), and the
    mesh carries the default process group."""
    device = torch.device(device)
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    if num_devices is not None and (num_devices < 1 or num_devices % world):
        raise ValueError(f"make_mesh: {num_devices} shards over {world} processes")
    local = None if num_devices is None else num_devices // world
    if device.type == "cuda":
        first = device.index or 0
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local is None:
            local = 1 if device.index is not None else visible
        if local < 1 or first + local > visible:
            raise RuntimeError(
                f"make_mesh: {local} CUDA card(s) from cuda:{first} asked for, {visible} "
                "visible; a mesh never repeats a card (name one explicitly, as "
                "Mesh((torch.device('cuda', 0),) * 4), to run several shards on it)")
        devices = [torch.device("cuda", first + k) for k in range(local)]
        if group is not None:
            torch.cuda.set_device(devices[0])
    elif device.type == "cpu":
        devices = [torch.device("cpu")] * (local or 1)
    else:
        raise ValueError(f"make_mesh: unsupported device {device}")
    mesh = Mesh(devices, group)
    if group is not None:
        counts = mesh.all_gather([torch.tensor(len(devices), device=d) for d in devices])
        assert all(int(c) == len(devices) for c in counts), \
            f"make_mesh: local shard counts differ across processes: {[int(c) for c in counts]}"
    return mesh


def shard_cyclic(arr, mesh: Mesh):
    """(n, ...) -> this process's shards, shard k = arr.reshape(n/d, d,
    ...)[:, k] (the global indices {l*d + k}) on its device."""
    d = mesh.size
    n = arr.shape[0]
    assert n % d == 0, f"n={n} not divisible by mesh size {d}"
    resh = arr.reshape(n // d, d, *arr.shape[1:])
    return [resh[:, mesh.offset + j].contiguous().to(dev) for j, dev in enumerate(mesh.devices)]


def unshard(parts):
    """All d shards (n/d, ...) on one device, in shard order (as
    Mesh.all_gather returns them) -> (n, ...) in global order."""
    return torch.stack(list(parts), dim=1).reshape(-1, *parts[0].shape[1:])


def z_product(mesh: Mesh, a, b):
    """Z = FE(prod_i Miller(A_i, B_i)) on the lead device: one single-mode K1
    launch per shard, the gather, the tree, one K2 launch.  (The JAX module
    runs Z through its cross-products program with A's halves swapped, to
    save an XLA program; eager launches need no such trick.)"""
    partials = [miller.miller_product(x, y) for x, y in zip(a, b)]
    f = ate.product_tree(torch.stack(mesh.all_gather(partials)))
    return fexp.final_exp(f[None])[0]


def cross_products(mesh: Mesh, a, b):
    """A round's (Z_L, Z_R) on the lead device, (2, 2,3,2,16): one pair-mode
    K1 launch per shard, the gather of the (d, 2, ...) partials, their tree
    in device order, one K2 launch at B = 2."""
    m = a[0].shape[0] // 2
    partials = [ate.cross_miller(x[:m], x[m:], y[:m], y[m:]) for x, y in zip(a, b)]
    return fexp.final_exp(ate.product_tree(torch.stack(mesh.all_gather(partials))))


def sipp_prove_sharded(a_g1, b_g2, mesh: Mesh):
    """The sharded SIPP prover; the same proof bytes as protocol.sipp_prove.

    a_g1: (n, 2, 16), b_g2: (n, 2, 2, 16), the whole instance in host order
    on any device (every process holds it and keeps its own shards); n a
    power of two with n >= d = mesh.size, d a power of two.  Returns the
    proof (2 log2(n) + 1, 2, 3, 2, 16) on the lead device."""
    n = prover.check_shapes(a_g1, b_g2)
    d = mesh.size
    if n < d or d & (d - 1):
        raise ValueError(f"sipp_prove_sharded: n={n} needs a mesh of a power of two <= n "
                         f"shards, got {d}")
    tr = prover.prologue(a_g1, b_g2)
    a, b = shard_cyclic(a_g1, mesh), shard_cyclic(b_g2, mesh)

    if n > d:
        z = z_product(mesh, a, b)
    else:       # one pair per shard: the lead device aggregates them all
        z = ate.inner_product(unshard(mesh.all_gather(a)), unshard(mesh.all_gather(b)))
    proof = [z]
    tr.append_fq12(tower.fq12_decode(z))

    while n > d:
        m = n // (2 * d)            # the local half
        bits_x, bits_xinv = prover.append_cross(tr, proof, cross_products(mesh, a, b))
        a = [fold.fold_g1(x[:m], x[m:], bits_x) for x in a]
        b = [fold.fold_g2(y[:m], y[m:], bits_xinv) for y in b]
        n //= 2

    prover.host_rounds(unshard(mesh.all_gather(a)), unshard(mesh.all_gather(b)), tr, proof)
    proof.reverse()
    return torch.stack(proof)
