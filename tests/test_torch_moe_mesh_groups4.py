"""An MoE's dispatch groups across ranks on a gloo world of 4 ranks: the
port's sharded rounds of deepseek-moe-16b smoke against the reference's
dense round (tests/test_torch_moe_mesh_groups.py has the world of 2, the
chunked cells and the rule; tests/torch_moe_mesh.py the setting).

Cells on data=4, 2 rounds at lr 0.1 from the reference's init: mtsl at
moe_groups 1 (one group over all four ranks), 4 (a group a rank) and 3
(groups of 32 tokens that straddle ranks); fedavg at 1 and 3. Losses
within 1e-5 of max(1, |loss|), every state leaf within 1e-5.
"""
from concurrent.futures import ThreadPoolExecutor

import pytest

import torch_moe_mesh as tm
from torch_mesh_ranks import max_gap, spawn

WORLD = 4
CELLS = [("mtsl", 1, None), ("mtsl", 4, None), ("mtsl", 3, None), ("fedavg", 1, None),
         ("fedavg", 3, None)]


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    send, join = spawn(WORLD, "rounds", tmp_path_factory.mktemp("moe_mesh4"))
    with ThreadPoolExecutor(len(CELLS)) as ex:
        list(ex.map(tm.init, tm.LOCAL))
        send(tm.payload(WORLD, CELLS))
        list(ex.map(lambda c: tm.reference(*c), CELLS))
    return join()


@pytest.mark.parametrize("world", [WORLD])
def test_setting_tells_global_from_per_rank_capacity(world):
    loss, kept, routed = tm.port_dense_round(1, tally=True)
    assert kept < routed, (kept, routed)  # the dense round drops rows
    per_rank, _, _ = tm.port_dense_round(world)  # capacity from each rank's tokens
    assert abs(per_rank - loss) > 100 * tm.TOL * max(1.0, abs(loss)), (per_rank, loss)


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


@pytest.mark.parametrize("world", [WORLD])
def test_mtsl_gathers_counts_once_a_layer(report, world):
    """mtsl gathers its counts once per MoE layer a round; fedavg's
    per-client dispatch gathers nothing beyond the round's own."""
    cells = report["cells"]
    mtsl = cells[tm.cell_key(world, "mtsl", 1)]["collectives"]["all_gather"]["calls"]
    fedavg = cells[tm.cell_key(world, "fedavg", 1)]["collectives"]["all_gather"]["calls"]
    assert mtsl == tm.ROUNDS * (2 + 1), mtsl
    assert fedavg == tm.ROUNDS * 1, fedavg
