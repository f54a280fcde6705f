"""What `correct` has to catch, at the smoke sizes on the CPU: the control
(the reference computed with float8 matmul operands in the program's
place) and the faults a cell can have, each planted under the timed path,
fail the cell's limits; the program in a lower precision than its
configuration states fails a comparison that the configured one passes;
the calibration's readings are judged by the same limits."""
import pytest
import torch

from perfbench.tests import smoke
from perfbench.lib import mtsl_train, result

TRAIN = [n for n in smoke.workloads() if n.endswith("mtsl-train")]
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", TRAIN)
def test_control_fails_the_limits(name):
    w = smoke.cell(name)
    seed = 99
    spec, first = _traffic(w, seed)
    from perfbench.reference import train as ref_train

    t = w["traffic_spec"]
    ref = ref_train.rounds(w["cfg"], spec, seed, first, t["lr"], 2, CPU)
    low = ref_train.rounds(w["cfg"], spec, seed, first, t["lr"], 2, CPU, "fp8")
    numbers = mtsl_train.compare(mtsl_train.as_program(low, t["lr"], 2), ref, t["lr"], 2)
    assert not result.judge(numbers, w["limits"]["limits"])[0], numbers


@pytest.mark.parametrize("name", TRAIN)
def test_lower_precision_program_fails_where_f32_passes(name):
    tight = {"loss_gap": 1e-5, "grad_gap": 1e-4}
    for dtype, ok in (("float32", True), ("bfloat16", False)):
        w = smoke.cell(name, dtype)
        p = mtsl_train.prepare(w, 5, CPU)
        numbers, _ = mtsl_train.check(w, 5, p.prog, p.first, p.spec, CPU)
        assert result.judge(numbers, tight)[0] is ok, (dtype, numbers)


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(name, monkeypatch):
    from repro_torch.optim import per_component

    monkeypatch.setattr(per_component, "mtsl_update_multi_", lambda *a, **k: None)
    rc, line, err = smoke.run(smoke.cell(name))
    assert rc == 0 and line["correct"] is False, err
    change = [v["value"] for k, v in line["compared"].items() if k.startswith("change")]
    assert change and max(change) == pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    from repro_torch.core import mtsl

    plain = mtsl._lm_loss

    def half(logits, tokens, *a):
        S = tokens.shape[-1]
        return plain(logits[:, :, :S // 2], tokens[:, :, :S // 2], *a)

    monkeypatch.setattr(mtsl, "_lm_loss", half)
    rc, line, err = smoke.run(smoke.cell(name))
    assert rc == 0 and line["correct"] is False, err


@pytest.mark.parametrize("name", TRAIN)
def test_bf16_witness_reads_under_the_control(name):
    """The reference rounded to bf16 where the program holds bf16 moves the
    comparison off zero, and less than the float8 control does."""
    w = smoke.cell(name)
    seed = 41
    spec, first = _traffic(w, seed)
    from perfbench.reference import train as ref_train

    t = w["traffic_spec"]
    ref = ref_train.rounds(w["cfg"], spec, seed, first, t["lr"], 2, CPU)
    got = {}
    for prec in ("bf16", "fp8"):
        low = ref_train.rounds(w["cfg"], spec, seed, first, t["lr"], 2, CPU, prec)
        got[prec] = mtsl_train.compare(mtsl_train.as_program(low, t["lr"], 2), ref,
                                       t["lr"], 2)["grad_median_gap"]["value"]
    assert 0 < got["bf16"] < got["fp8"], got


@pytest.mark.parametrize("name", TRAIN)
def test_calibration_lines_carry_the_judgement(name, monkeypatch, tmp_path):
    from perfbench import calibrate
    from perfbench.lib import bench

    w = smoke.cell(name)
    monkeypatch.setattr(bench, "cell", lambda n: w)
    out = tmp_path / "cal.jsonl"
    assert calibrate.main(["--workload", name, "--seeds", "7", "--program", "--control",
                           "--witness", "--fault", "half", "--device", "cpu",
                           "--out", str(out)]) == 0
    import json

    lines = {r["mode"]: r for r in map(json.loads, out.read_text().splitlines())}
    assert set(lines) == {"program", "control", "witness", "half"}
    limits = w["limits"]["limits"]
    for mode, r in lines.items():
        assert set(r["compared"]) == set(limits) and list(r)[-1] == "compared"
        assert r["correct"] is result.judge(r["numbers"], limits)[0]
    assert lines["program"]["correct"] and not lines["control"]["correct"]
    assert not lines["half"]["correct"]
    if w["cfg"]["family"] == "moe":
        kept, routed = lines["program"]["moe_kept"], lines["program"]["moe_routed"]
        assert 0 < kept <= routed
    else:
        assert "moe_kept" not in lines["program"]


def _traffic(w, seed):
    import itertools

    from perfbench.lib import weights
    from perfbench.lib.lm_data import MultiTaskLMSource, client_batches

    t = w["traffic_spec"]
    src = MultiTaskLMSource(t["data_vocab"], t["num_clients"], t["beta"], seed)
    first = list(itertools.islice(client_batches(src, t["batch_per_client"], t["seq_len"],
                                                 seed), t["compared_steps"]))
    return weights.specs(w["cfg"], t["num_clients"]), first
