"""``correct`` comes out false when the timed path is broken underneath:
a run of each nano cell on the CPU (the harness's own path, without its
look for a card) with a fault planted in the program, once for each fault
the cell can have.  One chip, so no exchange between chips can be left
out.  And the controls: the program's own int8 path for the serving
cells and TF32 in the reference's place for the float32 training cell (on
a card only), and the fp8 reference in the program's place on the CPU."""

import contextlib

import pytest

from gwt_bench import control, run, specs


def cpu_run(cell, roots, seed=31):
    return run.run_cell(cell, seed, 0.3, False, device="cpu", roots=roots,
                        setup_clock=lambda: 0.0)


@contextlib.contextmanager
def patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def altered_token(real):
    """The sampler's token of row 0 changed at step 3, its log-prob not."""
    calls = {"n": 0}

    def fake(*a, **kw):
        out = real(*a, **kw)
        calls["n"] += 1
        if calls["n"] % 7 == 3:
            tok = out.token.clone()
            tok[0] = (tok[0] + 1) % 50000
            out = out._replace(token=tok)
        return out
    return fake


def stale_cache(real):
    """A decode step whose K/V writes are lost: the cache comes back as it
    was."""
    def fake(params, config, token, pos, kv, *a, **kw):
        logits, _ = real(params, config, token, pos,
                         type(kv)(kv.k.clone(), kv.v.clone()), *a, **kw)
        return logits, kv
    return fake


def half_batch_answered(real):
    def fake(self, clips, tparams=None):
        n = len(clips) // 2
        return real(self, clips[:n], tparams) + [[] for _ in clips[n:]]
    return fake


def test_sound_runs_are_correct(roots):
    assert cpu_run("nano.batch", roots)["correct"] is True
    assert cpu_run("nano.train", roots)["correct"] is True


@pytest.mark.parametrize("fault", ["token", "cache", "half_batch",
                                   "second_best"])
def test_serving_faults_are_caught(fault, roots):
    from godot_whisper_tpu_torch.decode import window
    from godot_whisper_tpu_torch.parallel import batch
    plant = {"token": lambda: patched(window, "fused_filter_sample",
                                      altered_token),
             "cache": lambda: patched(window, "decoder_step", stale_cache),
             "half_batch": lambda: patched(batch.BatchTranscriber,
                                           "transcribe", half_batch_answered),
             "second_best": control.second_best}[fault]
    with plant():
        out = cpu_run("nano.batch", roots)
    assert out["correct"] is False, out["compared"]


def test_second_best_is_caught_by_the_gap_alone(roots):
    """A sampler that picks the second-best token and reports that token's
    own log-probability: the log-probabilities agree with the reference's,
    only the served tokens' gap below its best shows the fault."""
    with control.second_best():
        c = cpu_run("nano.batch", roots)["compared"]
    assert c["logprob_m4"]["value"] <= c["logprob_m4"]["limit"]
    assert c["widest_gap"]["value"] > c["widest_gap"]["limit"]


def unchanged_state(real):
    def fake(state, *a, **kw):
        _, loss = real(state, *a, **kw)
        return state._replace(step=state.step + 1), loss
    return fake


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_caught(fault, roots):
    from godot_whisper_tpu_torch.models import training
    ctx = (patched(training, "train_step", unchanged_state)
           if fault == "unchanged" else control.half_batch())
    with ctx:
        out = cpu_run("nano.train", roots)
    assert out["correct"] is False, out["compared"]


def test_serving_reference_control_fails(roots):
    """The reference put in the program's place at fp8 comes out not
    correct (at nano size the program's int8 path does not always:
    its int8 error is of the order of its bf16 one; at the cell's size it
    does, on the card, below)."""
    spec = specs.workload("nano.batch", roots)
    cfg = specs.config(spec["config"], roots)
    assert control.batch_reading(cfg, spec, 3, "sound", 2, "cpu")["correct"]
    assert not control.batch_reading(cfg, spec, 3, "fp8", 2, "cpu")[
        "correct"]


@pytest.mark.cuda
def test_serving_control_fails_on_card(card):
    """The program's int8 path at turbo.batch.long's own size, one batch."""
    spec = specs.workload("turbo.batch.long")
    cfg = specs.config(spec["config"])
    assert not control.batch_reading(cfg, spec, 17, "int8", 1, card)[
        "correct"]


@pytest.mark.cuda
def test_training_control_fails_on_card(roots, card):
    """TF32 in the reference's place reads above the float32 nano cell's
    limits (TF32 exists on the card only)."""
    spec = specs.workload("nano.train", roots)
    cfg = specs.config(spec["config"], roots)
    r = control.train_reading(cfg, spec, 5, "tf32", card)
    assert not r["correct"], r
