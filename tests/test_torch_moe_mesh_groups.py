"""An MoE's dispatch groups across ranks (`models/moe.py`, `round_tokens`):
the port's sharded rounds of deepseek-moe-16b smoke on a gloo world of 2
ranks against the reference's rounds, and the rank layout under a client
chunk (`utils.sharding.rank_rows`). The world of 4 ranks is
tests/test_torch_moe_mesh_groups4.py; the setting and the helpers are
tests/torch_moe_mesh.py's.

The reference dispatches the round's tokens (under a client chunk, the
chunk's) in cfg.moe_groups groups, each with its own expert capacity;
moe_groups = 1 (its default) is one group over every client's tokens. A
rank of the port holds its block of clients, so of tokens, and keeps a
row iff its position among the rows of its (group, expert) on lower ranks
and its own is below the capacity: the reference's stable-sort rule.
Under chunk c a rank holds c/D clients of each chunk, so that the ranks'
parts of chunk j are the reference's chunk j, clients [j·c, (j+1)·c).

Cells on data=2, each held against the reference's round from its init,
2 rounds at lr 0.1: losses within 1e-5 of max(1, |loss|), every state
leaf within 1e-5:

  * unchunked, against the reference's dense round: mtsl at moe_groups 1
    (one group over both ranks), 2 (a group a rank) and 3 (groups of 32
    tokens that straddle ranks); fedavg at 1 and 3 (each client's full
    model dispatches its own tokens, on its own rank); mtsl at 1 with
    remat "block" (the backward dispatches, and gathers, again); and that
    with an MoE layer in each tower (3 layers, 2 in the towers), which
    dispatches its one client's tokens alone, on its rank;
  * at client_chunk 2 (M 4: one client of each chunk a rank), against the
    reference's chunked round without a mesh: mtsl at moe_groups 1 and 3,
    at 1 under remat and at 1 with a tower MoE layer; each gathers its
    counts once per MoE layer per chunk, as its unchunked twin does per
    layer;
  * a chunked run through train() on data=2 checkpointed after 2 of 4
    rounds: the file is the ranks' gathered state bit for bit, in client
    order (within 1e-5 of the chunked run without a mesh), and a run
    without a mesh resumed from it ends within 1e-5 of the mesh run.

Before that the tests show the setting tells the semantics apart: the
port's dense round drops rows (its dispatch tally); per-rank capacity (a
group a rank) gives another loss; and the contiguous grouping under a
chunk (rank r holding clients [r·M/D, (r+1)·M/D), so chunks {0, 2} and
{1, 3}) gives a loss more than 100 x 1e-5 from the reference's chunked
round.
"""
import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_moe_mesh as tm
from repro_torch.configs import get_config
from repro_torch.train.checkpoint import load_algorithm_state
from repro_torch.utils.sharding import ClientGroup, rank_rows
from torch_mesh_ranks import flat_state, lm_train, max_gap, spawn

WORLD = 2
CELLS = [("mtsl", 1, None), ("mtsl", 2, None), ("mtsl", 3, None), ("fedavg", 1, None),
         ("fedavg", 3, None), ("mtsl", "1-remat", None), ("mtsl", "1-tower", None),
         ("mtsl", 1, tm.CHUNK), ("mtsl", 3, tm.CHUNK), ("mtsl", "1-remat", tm.CHUNK),
         ("mtsl", "1-tower", tm.CHUNK)]
CHUNKED = [c for c in CELLS if c[2] is not None]


def _ckpt(tmp):
    return {"mesh": f"data={WORLD}", "cfg": {"arch": tm.ARCH, "updates": tm.updates(1)},
            "M": tm.M, "b": tm.B, "S": tm.S, "lr": tm.LR, "chunk": tm.CHUNK,
            "cut": tm.CUT, "rounds": tm.CKPT_ROUNDS, "path": str(tmp / "chunked.msgpack"),
            "init": tm.init("mtsl")[1]}


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """The world starts while the parent draws the inits; it runs its cells
    while the parent runs the reference's rounds."""
    tmp = tmp_path_factory.mktemp("moe_mesh2")
    send, join = spawn(WORLD, "rounds", tmp)
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(tm.init, tm.LOCAL))
        tm.init("mtsl", True)
        ckpt = _ckpt(tmp)
        send(tm.payload(WORLD, CELLS, ckpt))
        list(ex.map(lambda c: tm.reference(*c), CELLS))
    return {**join(), "ckpt": ckpt}


@pytest.mark.parametrize("world", [WORLD])
def test_setting_tells_global_from_per_rank_capacity(world):
    loss, kept, routed = tm.port_dense_round(1, tally=True)
    assert kept < routed, (kept, routed)  # the dense round drops rows
    per_rank, _, _ = tm.port_dense_round(world)  # capacity from each rank's tokens
    assert abs(per_rank - loss) > 100 * tm.TOL * max(1.0, abs(loss)), (per_rank, loss)


def test_contiguous_grouping_under_a_chunk_is_another_round():
    """The grouping a contiguous block a rank gave under chunk 2 (rank 0
    clients 0, 1 and rank 1 clients 2, 3, each scanning one client a
    chunk: chunks {0, 2} and {1, 3}) is the reference's chunked round on
    the clients reordered (0, 2, 1, 3); the layout rule's grouping is the
    reference's own."""
    loss, want = tm.port_reference_init_round(1, None, tm.CHUNK)
    assert abs(loss - want) <= tm.TOL * max(1.0, abs(want)), (loss, want)
    per = tm.CHUNK // WORLD  # each rank's part of a chunk
    blocks = [range(r * tm.M // WORLD, (r + 1) * tm.M // WORLD) for r in range(WORLD)]
    old = [c for j in range(0, tm.M // WORLD, per) for b in blocks for c in b[j:j + per]]
    assert old == [0, 2, 1, 3]
    loss_old, _ = tm.port_reference_init_round(1, old, tm.CHUNK)
    assert abs(loss_old - want) > 100 * tm.TOL * max(1.0, abs(want)), (loss_old, want)


def _reference_layout(M, D, c, r):
    """The clients the reference's device r holds of a [M/c, c] chunked
    leaf whose in-chunk dim is split over D devices (`_chunk_spec_sharding`:
    P(None, client axes)), chunk after chunk; without a chunk, its block
    of the leading dim."""
    c = M if c is None or c >= M else c
    grid = np.arange(M).reshape(M // c, c)
    return np.split(grid, D, axis=1)[r].reshape(-1).tolist()


@pytest.mark.parametrize("M,D,c", [(4, 2, None), (4, 2, 2), (4, 2, 4), (8, 2, 2),
                                   (8, 2, 4), (8, 4, 4), (12, 2, 6), (16, 4, 8),
                                   (12, 3, 6), (8, 2, 16)])
def test_rank_rows_layout(M, D, c):
    rows = [ClientGroup(None, D, r).rows(M, c) for r in range(D)]
    ids = [list(range(M))[x] if isinstance(x, slice) else x for x in rows]
    assert sorted(i for x in ids for i in x) == list(range(M))
    assert all(len(x) == M // D for x in ids)
    assert ids == [_reference_layout(M, D, c, r) for r in range(D)]
    cc = M if c is None or c >= M else c
    per = cc // D
    for j in range(M // cc):  # the ranks' parts of chunk j, in rank order
        assert sum((x[j * per:(j + 1) * per] for x in ids), []) == list(
            range(j * cc, (j + 1) * cc))
    if cc == M:  # no chunk: the contiguous block, as before
        assert rows == [slice(r * M // D, (r + 1) * M // D) for r in range(D)]
    with pytest.raises(ValueError, match="multiple of the mesh's client-shard count"):
        rank_rows(M, D, 0, 1)


@pytest.mark.parametrize("cell", [(WORLD, *c) for c in CELLS], ids=tm.cell_id)
def test_sharded_moe_round_matches_reference(report, cell):
    _, alg, groups, chunk = cell
    losses, state, _, spread = report["cells"][tm.cell_key(*cell)]["mesh"]
    assert spread == 0.0  # every rank gathers the same state
    want_losses, want_state = tm.reference(alg, groups, chunk)
    scale = max(1.0, max(abs(x) for x in want_losses))
    gap = max(abs(a - b) for a, b in zip(losses, want_losses))
    assert len(losses) == tm.ROUNDS and gap <= tm.TOL * scale, (losses, want_losses)
    assert max_gap(state, want_state) <= tm.TOL


def _gathers(report, *cell):
    return report["cells"][tm.cell_key(WORLD, *cell)]["collectives"]["all_gather"]["calls"]


@pytest.mark.parametrize("world", [WORLD])
def test_mtsl_gathers_counts_once_a_layer(report, world):
    """mtsl's rank-aware dispatch all-gathers its [G, E] counts once per
    MoE layer a round (the server has one), twice under remat; fedavg's
    per-client dispatch gathers nothing beyond the round's own."""
    gathers = {k: _gathers(report, *k) for k in (("mtsl", 1, None), ("fedavg", 1, None))}
    # a round's own gathers: mtsl's per-task losses twice (objective,
    # metrics), fedavg's once
    assert gathers[("mtsl", 1, None)] == tm.ROUNDS * (2 + 1), gathers
    assert gathers[("fedavg", 1, None)] == tm.ROUNDS * 1, gathers
    remat = _gathers(report, "mtsl", "1-remat", None)  # dispatches again in the backward
    assert remat == tm.ROUNDS * (2 + 2), remat


@pytest.mark.parametrize("cell", [(WORLD, *c) for c in CHUNKED], ids=tm.cell_id)
def test_chunked_mtsl_gathers_counts_once_a_layer_a_chunk(report, cell):
    """Under a chunk each chunk's server dispatches on its own: the counts
    are gathered once per MoE layer per chunk (per pass under remat), as
    its unchunked twin gathers them once per layer; the round's own
    gathers (the per-task losses, twice) are the twin's."""
    _, alg, groups, chunk = cell
    own = tm.ROUNDS * 2
    twin = _gathers(report, alg, groups, None) - own
    assert twin > 0
    assert _gathers(report, alg, groups, chunk) - own == (tm.M // chunk) * twin


def test_chunked_mesh_checkpoint_resumes_without_a_mesh(report):
    p, ranks = report["ckpt"], report["train"]
    cfg = get_config(tm.ARCH, smoke=True).with_updates(**tm.updates(1))
    state, _, extra = load_algorithm_state(p["path"], "mtsl", cfg=cfg)
    assert extra["round"] == p["cut"]
    got, want = flat_state(state), ranks["cut"][1]
    assert sorted(got) == sorted(want)
    for k in got:  # the whole state, in client order, bit for bit
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # against the chunked run without a mesh: the same clients in each row
    plain, plain_hist = lm_train(p, None, p["cut"], init=copy.deepcopy(p["init"]))
    scale = max(1.0, max(abs(e["loss"]) for e in plain_hist))
    assert max(abs(a - e["loss"]) for a, e in zip(ranks["cut"][0], plain_hist)) <= (
        tm.TOL * scale)
    assert max_gap(got, flat_state(plain)) <= tm.TOL
    # resumed without a mesh, on to the mesh run's end
    s2, h2 = lm_train(p, None, p["rounds"], init=state, start=p["cut"])
    assert [e["round"] for e in h2] == list(range(p["cut"] + 1, p["rounds"] + 1))
    gap = max(abs(a - e["loss"]) for a, e in zip(ranks["end"][0], h2))
    assert gap <= tm.TOL * max(1.0, max(abs(x) for x in ranks["end"][0])), gap
    assert max_gap(flat_state(s2), ranks["end"][1]) <= tm.TOL
