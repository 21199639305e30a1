"""The check that decides ``correct``, on the CPU at a small size (3 trials,
700 rows, B 128): the port agrees with the plain reference on a faithful
batch of both forms, and the control and every planted fault come out not
correct; on a CUDA device (marked ``chip``), the same at the cells' own
size."""
import time

import pytest

from benchmark import check, faults, harness, readings

CELLS = ("normal-train-t256", "compact-train-t256")


def limits(workload):
    spec = harness.load_spec()
    return harness.load_cell(workload, spec)[1]["limits"]


def small_run(workload, seed):
    return harness.run(workload, seed, 0.0, False, time.perf_counter(), device="cpu",
                       resize=readings.small)


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(workload, capsys):
    result = small_run(workload, 2**31 + 11)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert "check loss:" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ("bf16",) + faults.FAULTS)
def test_control_and_faults_are_not_correct(mode):
    r = readings.reading("compact-train-t256", mode, 2**31 + 12, "cpu", readings.small)
    correct, checks = check.judge(r["numbers"], limits("compact-train-t256"))
    assert not correct, checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_run_with_a_broken_path_is_not_correct(fault):
    with faults.planted(fault):
        result = small_run("compact-train-t256", 2**31 + 13)
    assert not result["correct"], result["checks"]


def test_draws_and_start_are_checked():
    """A draw the program makes from another distribution, or weights that
    are not the benchmark's, each fail the check."""
    spec = harness.load_spec()
    cell, config, traffic = harness.load_cell("compact-train-t256", spec)
    params, traffic = readings.small(harness.program_params(config, traffic), traffic)
    model = harness.load_model(config)
    c = harness.Cell(params, traffic, 5, "cpu", model)
    record = c.recorded_epoch()
    host = c.host
    perm = record["head"][0]
    record["head"][0] = (perm[0], perm[1], perm[2].clone().fill_(0))
    record["weights0"]["dis"]["lin_out.bias"] += 1.0
    numbers = check.run_reference(params, record, host, 0, "cpu", model=model)
    assert numbers["draws"] > 0 and numbers["start"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(cuda, workload):
    result = harness.run(workload, 2**31 + 21, 5.0, False, time.perf_counter())
    assert result["correct"], result["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_fails_on_the_card(cuda, workload):
    r = readings.reading(workload, "tf32", 2**31 + 22)
    assert not check.judge(r["numbers"], limits(workload))[0], r


def test_combined_metric_is_held_by_the_size_of_its_terms():
    """The combined metric's gap counts over the sum of its weighted terms'
    magnitudes, not over the combined value, which passes near 0."""
    import numpy as np

    from benchmark import reference as ref

    spec = harness.load_spec()
    cell, config, traffic = harness.load_cell("compact-train-t256", spec)
    params, traffic = readings.small(harness.program_params(config, traffic), traffic)
    model = harness.load_model(config)
    c = harness.Cell(params, traffic, 7, "cpu", model)
    record = c.recorded_epoch()
    host = c.host
    shift = 1e-3
    record["log"]["combined"] += shift
    numbers = check.run_reference(params, record, host, 0, "cpu", model=model)
    terms = np.abs(np.multiply(ref.METRIC_WEIGHTS, record["log"]["metrics"].double().numpy()))
    largest = shift / terms.sum(axis=1).min()
    assert numbers["val"] == pytest.approx(largest, rel=1e-3)
