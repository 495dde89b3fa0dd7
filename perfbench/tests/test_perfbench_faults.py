"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: a step that returns its state unchanged, half
of each batch left out (the mean over the rest), and an answer altered
where it is produced; and the control (the reference in TF32, put in the
program's place) fails the cell's limits.  One chip: no exchange between
chips to leave out."""
from types import SimpleNamespace

import torch

import run
from fedbench import check, inputs, program


def _run(tiny):
    return run.run_cell(tiny, seed=77, seconds=0.1, traced=False,
                        device="cpu")


def test_a_step_that_leaves_the_state_unchanged_fails(tiny, monkeypatch):
    from repro_torch.api.federation import Federation
    step = Federation.step

    def frozen(self):
        before = dict(self.engine.params)
        rec = step(self)
        self.engine.params = before
        return rec
    monkeypatch.setattr(Federation, "step", frozen)
    out = _run(tiny)
    assert out["correct"] is False
    # no change at all: each leaf's gap is its whole norm
    assert max(c["value"] for name, c in out["checks"].items()
               if name != "loss_gap") > 0.9


def test_half_of_the_batch_left_out_fails(tiny, monkeypatch):
    from repro_torch.models import transformer
    loss_sum = transformer.train_loss_sum

    def half(params, cfg, batch, **kw):
        mask = batch["doc_mask"]
        keep = torch.arange(mask.shape[-1]) < mask.shape[-1] // 2
        return loss_sum(params, cfg, {**batch, "doc_mask": mask * keep},
                        **kw)
    monkeypatch.setattr(transformer, "train_loss_sum", half)
    assert _run(tiny)["correct"] is False


def test_an_answer_altered_where_it_is_produced_fails(tiny, monkeypatch):
    from repro_torch.kernels import ops
    combine = ops.fed_weighted_combine
    monkeypatch.setattr(ops, "fed_weighted_combine",
                        lambda *a, **k: combine(*a, **k) * 1.01)
    out = _run(tiny)
    assert out["correct"] is False


def test_the_control_in_tf32_fails_the_limits(tiny):
    dev = torch.device("cpu")
    cfg, traffic = tiny["config"], tiny["traffic"]
    for seed in (5, 2 ** 31 + 1):
        st = SimpleNamespace(shapes=program.param_shapes(cfg),
                             exec_seed=seed,
                             docs=inputs.make_docs(traffic,
                                                   cfg["vocab_size"], seed,
                                                   dev))
        ref = run.reference(tiny, seed, st, dev)
        control = run.reference(tiny, seed, st, dev, precision="tf32")
        ok, checks = check.judge(check.numbers(control, ref), tiny["limits"])
        assert not ok, checks
