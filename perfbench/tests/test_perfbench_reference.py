"""The plain reference against the program's own rounds, on the CPU at
tiny widths: a whole run of each cell comes out correct, its line has
exactly the keys the driver reads, and the reference owes the program
nothing."""
import json

import pytest
import torch

import run
from fedbench import cells
from reference import draws

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_a_cpu_run_of_each_cell_is_correct_and_well_formed(tiny):
    out = run.run_cell(tiny, seed=2 ** 31 + 11, seconds=0.2, traced=False,
                       device="cpu")
    assert list(out) == KEYS                       # checks last
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"fed_train_tokens_per_s", "setup_s"}
    assert out["metrics"]["fed_train_tokens_per_s"]["unit"] == "tokens/s"
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(tiny["limits"])
    for c in out["checks"].values():
        assert 0.0 <= c["value"] < 0.05 * c["limit"]
    json.dumps(out)


def test_a_traced_cpu_run_keeps_the_same_keys(tiny):
    out = run.run_cell(tiny, seed=3, seconds=0.2, traced=True, device="cpu")
    assert list(out) == KEYS and out["correct"] is True


def test_the_round_draws_are_jax_permutations():
    from repro_torch.core import prng
    for n, seed, client in ((14, 5, 2), (3, 2 ** 32 + 9, 0), (1, 0, 3),
                            (10, 123456789 * 100003 + 2, 1)):
        key = prng.fold_in(prng.PRNGKey(seed), client)
        want = prng.choice(key, n, min(4, n)).tolist()
        assert draws.client_draws(seed, client, n, 4)[0] == want


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from conftest import BENCH
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in getattr(node, "names", [])] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro",
                                                  "fedbench", "counts"), \
                    f"{path.name} imports {name}"


def test_main_refuses_a_host_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "fedlm-hymba-topk-vmap", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_main_refuses_too_few_cards(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "fedlm-mamba2-fedavg-vmap", "--seed",
                     "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_unknown_cell_is_refused():
    with pytest.raises(cells.UnknownName):
        run.main(["--workload", "fedlm-nothing", "--seed", "1",
                  "--seconds", "1"])
