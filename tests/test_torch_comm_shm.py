"""The shared-memory transport of gloo groups on one host
(``deepspeed_tpu_torch/comm/shm.py``), over 2 and 4 gloo ranks on the CPU:

- every gloo group of one host gets a channel, and the facade's raw ops go
  through it;
- ``all_gather``, ``all_to_all`` and ``ppermute`` move the bytes gloo's own
  collectives move, bit for bit, in float32, bfloat16, float8 and bool;
- ``reduce_scatter`` and ``all_reduce`` (sum, max, min, mean) equal the
  reduction of the gathered payloads in group-rank order, one add at a
  time, bit for bit, and every rank holds the same all-reduce; in float32
  they are within 1e-6 of gloo's own all-reduce (which adds in ring order);
- all of it again on a channel of 256-byte segments, where every payload
  but the smallest goes in pieces, with a payload three segments long and
  an empty one; a subgroup has a channel of its own;
- nothing is left under ``/dev/shm``.
"""

import os

import pytest
import torch

from deepspeed_tpu_torch.testing import run_distributed

SPAWN_TIMEOUT = 300


def _check(world, rank, group, grank):
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import comm, shm
    from deepspeed_tpu_torch.comm.comm import ReduceOp
    ch = shm.channel(group)
    assert ch is not None and ch.world == world and ch.me == grank
    g = torch.Generator().manual_seed(100 + rank)
    for dtype in (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
                  torch.bool):
        for rows in (1, 37):
            x = torch.randn(world, rows, 5, generator=g)
            x = (x > 0) if dtype == torch.bool else x.to(dtype)
            # the moving ops against gloo's own, on the payload's bytes
            raw = x.view(torch.uint8) if dtype == torch.float8_e4m3fn else x
            got = comm.raw_all_gather(x, group, world)
            want = torch.empty(world * raw.numel(), dtype=raw.dtype)
            dist.all_gather_into_tensor(want, raw.reshape(-1), group=group)
            assert torch.equal(got.reshape(-1).view(raw.dtype), want)
            got = comm.raw_all_to_all(x, group, world)
            want = torch.empty_like(raw.reshape(-1))
            dist.all_to_all_single(want, raw.reshape(-1), group=group)
            assert torch.equal(got.reshape(-1).view(raw.dtype), want)
            gathered = comm.raw_all_gather(x, group, world)
            source = (grank - 1) % world
            got = ch.permute(x, source)
            assert torch.equal(got.view(raw.dtype),
                               gathered[source].view(raw.dtype))
            assert not ch.permute(x, None).any()
            if dtype in (torch.float8_e4m3fn, torch.bool):
                continue
            # the reductions: group-rank order, one add at a time
            want = gathered[0][grank].clone()
            for j in range(1, world):
                want += gathered[j][grank]
            assert torch.equal(comm.raw_reduce_scatter(x, group, world), want)
            total = gathered[0].clone()
            for j in range(1, world):
                total += gathered[j]
            assert torch.equal(comm.raw_all_reduce(x, group, world), total)
            assert torch.equal(
                comm.raw_all_reduce(x, group, world, ReduceOp.AVG),
                total / world)
            assert torch.equal(
                comm.raw_all_reduce(x, group, world, ReduceOp.MAX),
                gathered.amax(0))
            assert torch.equal(
                comm.raw_all_reduce(x, group, world, ReduceOp.MIN),
                gathered.amin(0))
            every = comm.raw_all_gather(comm.raw_all_reduce(x, group, world),
                                        group, world)
            assert all(torch.equal(every[0], e) for e in every)
            if dtype == torch.float32:
                ring = x.clone()
                dist.all_reduce(ring, group=group)
                torch.testing.assert_close(total, ring, rtol=1e-6, atol=1e-6)
    if ch.segments[0].bytes.numel() > 256:
        return
    # a payload three segments long goes in pieces
    cols = 3 * ch.segments[0].bytes.numel() // world + 7
    big = torch.arange(world * cols, dtype=torch.int32).reshape(world, cols)
    big = (big + 1000 * grank) % 251
    got = comm.raw_all_to_all(big.to(torch.uint8), group, world)
    rows = torch.arange(world * cols, dtype=torch.int32).reshape(world, cols)
    want = torch.stack([(rows[grank] + 1000 * j) % 251
                        for j in range(world)]).to(torch.uint8)
    assert torch.equal(got, want)
    small = torch.tensor([float(grank + 1)])
    assert float(comm.raw_all_reduce(small, group, world)) == \
        world * (world + 1) / 2
    empty = torch.empty(world, 0)
    assert comm.raw_all_to_all(empty, group, world).shape == (world, 0)


def shm_body():
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import shm
    rank, world = dist.get_rank(), dist.get_world_size()
    _check(world, rank, dist.group.WORLD, rank)      # one piece a payload
    # channels made from here on map 256-byte segments: every payload but
    # the smallest goes in pieces
    shm.Channel.CAPACITY = 256
    again = dist.new_group(list(range(world)))
    _check(world, rank, again, rank)
    assert shm.channel(again).segments[0].bytes.numel() == 256
    # a subgroup of the even ranks: a channel of its own
    evens = list(range(0, world, 2))
    sub = dist.new_group(evens)
    if rank in evens:
        _check(len(evens), rank, sub, evens.index(rank))
        assert shm.channel(sub) is not shm.channel(dist.group.WORLD)
    dist.barrier()
    names = [shm.channel(g).name for g in (dist.group.WORLD, again)]
    if rank in evens:
        names.append(shm.channel(sub).name)
    left = [f for f in os.listdir("/dev/shm")
            if any(f.startswith(n) for n in names)]
    assert not left, left
    print("SHM_OK", rank)


@pytest.mark.parametrize("world", [2, 4])
def test_shm_channel_matches_gloo(world):
    outs = run_distributed(shm_body, world, timeout=SPAWN_TIMEOUT,
                           device="cpu")
    for rank, out in enumerate(outs):
        assert f"SHM_OK {rank}" in out, out
