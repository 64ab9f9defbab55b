"""Multiple processes in the port (parallel/dist.py, the dp x tp training
step, the batch CLI's multi-process flags) on the CPU over gloo, against
the JAX package.  The workers are this file run as a script
(``torch_workers.py``); the JAX references run in the pytest process.

- ``MultiHostBatchTranscriber`` (nano with 3 text layers, f32): 2
  processes with clip counts [2, 2],
  [3, 1] and [3, 0] (dummy rows, a process with no clips, ragged frame
  capacities), and a tp 2 group decoding its ranks' clips [2, 1] together;
  every process's segments equal the JAX single-process
  ``BatchTranscriber`` on the same clips (the oracle of
  ``tests/test_multihost.py``);
- training on a dp 2 x tp 2 mesh (4 processes, nano f32, B 4 split 2 + 2,
  T 8): the loss and every gathered gradient leaf against jitted
  ``jax.value_and_grad(loss_fn)`` on the whole batch within 1e-5 of the
  leaf's largest element, and params / AdamW moments after two steps
  against two jitted JAX ``train_step``s;
- the batch CLI in 2 processes (``--coordinator --num-processes
  --process-id``, then with ``--tp 2``) writes the files of the
  single-process CLI."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import godot_whisper_tpu_torch as gt

import torch_workers as tw

SCRIPT = os.path.abspath(__file__)
COUNTS = {"2-2": [2, 2], "3-1": [3, 1], "3-0": [3, 0]}
TP_COUNTS = [2, 1]
B, T, LR = 4, 8, 1e-4
GRAD_F32 = 1e-5     # of the leaf's largest element (the one-process limit)
MOMENT_F32 = 1e-5
LOSS_F32 = 1e-5


def _nano(pkg, n_text_layer=2, **kw):
    """nano (2 + 2 layers, width 128, 4 heads); with 3 text layers it is
    not a distilled model and its segments carry timestamps."""
    return pkg.get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=n_text_layer, n_audio_state=128,
        n_audio_head=4, n_text_state=128, n_text_head=4, name="nano", **kw)


def make_clip(global_idx: int) -> np.ndarray:
    """The JAX multi-host test's clip recipe (tests/multihost_worker.py):
    lengths grow with the global index, so processes disagree on the mel
    frame capacity before they agree."""
    rng = np.random.default_rng(100 + global_idx)
    seconds = 2.0 + 0.5 * global_idx
    freq = 220.0 * (1 + global_idx)
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * freq * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _train_batch(cfg):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.n_vocab, (B, T + 1)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0
    mask[3, 2:] = 0.0
    return {"mel": rng.standard_normal((B, 2 * cfg.n_audio_ctx, cfg.n_mels)
                                       ).astype(np.float32),
            "tokens": tok[:, :-1], "targets": tok[:, 1:], "mask": mask}


def _segs(ss):
    return [[s.t0, s.t1, s.text, [t.id for t in s.tokens]] for s in ss]


# ================================================================ workers ==
def _batch(rank, world, out):
    import torch.distributed as tdist
    from godot_whisper_tpu_torch.parallel import dist
    cfg = _nano(gt, n_text_layer=3)
    tparams = gt.TranscribeParams(best_of=1, temperature_inc=0.0)
    res = {}
    try:
        dist.stream_mesh(tp=4, device="cpu")
    except ValueError as e:
        res["tp4_error"] = str(e)
    for tp, cases in ((1, COUNTS), (2, {"tp2": TP_COUNTS})):
        ctx = gt.WhisperContext.from_params(
            cfg, gt.init_params(cfg, seed=0, compute_dtype=torch.float32,
                                device="cpu"), device="cpu")
        mesh = dist.stream_mesh(tp=tp, device="cpu")
        mht = dist.MultiHostBatchTranscriber(ctx, mesh)
        # the groups of the host gathers: [group, carries clips]
        gathers, gather = [], tdist.all_gather_object

        def spy(out, obj, group=None):
            gathers.append(["tp" if group is mesh.tp_host_group else "host"
                            if group is mesh.host_group else "other",
                            isinstance(obj, tuple)])
            return gather(out, obj, group=group)
        tdist.all_gather_object = spy
        for name, counts in cases.items():
            base = sum(counts[:rank])
            clips = [make_clip(base + i) for i in range(counts[rank])]
            res[name] = [_segs(s) for s in mht.transcribe(clips, tparams)]
        tdist.all_gather_object = gather
        res[f"gathers_tp{tp}"] = sorted(set(map(tuple, gathers)))
    with open(os.path.join(out, f"batch{rank}.json"), "w") as f:
        json.dump(res, f)


def _train(rank, world, out):
    """dp 2 x tp 2: the loss and gradients of the first batch, then two
    train_steps; every rank's local trees go to rank 0, which unshards
    each dp shard's and writes them."""
    import torch.distributed as dist
    from godot_whisper_tpu_torch.models import training as tt
    from godot_whisper_tpu_torch.models.params import params_to_numpy
    from godot_whisper_tpu_torch.parallel.sharding import (
        batch_sharding, make_mesh, shard_params, unshard_params)
    cfg = _nano(gt, n_audio_ctx=64)
    mesh = make_mesh(2, 2, device="cpu")
    full = gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                          device="cpu")
    rows = batch_sharding(mesh, B)
    batch = {k: v[rows] for k, v in _train_batch(cfg).items()}
    state = tt.init_train_state(shard_params(full, mesh, cfg), lr=LR)
    loss, grads = tt.loss_and_grads(state.params, cfg, batch, device="cpu",
                                    mesh=mesh)
    losses = []
    for _ in range(2):
        state, step_loss = tt.train_step(state, cfg, batch, lr=LR,
                                         device="cpu", mesh=mesh)
        losses.append(float(step_loss))
    mine = (mesh.dp_index, mesh.tp_index, float(loss), losses, grads,
            state.params, state.opt_state.mu, state.opt_state.nu)
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank != 0:
        return
    res = {"loss": [e[2] for e in every], "steps": [e[3] for e in every]}
    for d in range(2):
        shard = sorted((e for e in every if e[0] == d), key=lambda e: e[1])
        for i, name in ((4, "grads"), (5, "params"), (6, "mu"), (7, "nu")):
            tree = params_to_numpy(unshard_params([e[i] for e in shard],
                                                  cfg))
            np.savez(os.path.join(out, f"{name}_dp{d}.npz"),
                     **{"/".join(p): a for p, a in _flat(tree)})
    with open(os.path.join(out, "train.json"), "w") as f:
        json.dump(res, f)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _worker_main(argv):
    mode, rank, world, port, out, _ = tw.worker_args(argv)
    tw.init_gloo(rank, world, port)
    {"batch": _batch, "train": _train}[mode](rank, world, out)
    import torch.distributed as dist
    dist.destroy_process_group()


# ======================================================== multi-process ==
@pytest.fixture(scope="module")
def batch_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("batch")
    tw.run_workers(SCRIPT, "batch", 2, out, timeout=300)
    return [json.load(open(out / f"batch{r}.json")) for r in range(2)]


@pytest.fixture(scope="module")
def jax_batch():
    """The JAX single-process BatchTranscriber over clips 0..n-1 (the
    tests/test_multihost.py oracle), per n."""
    import jax.numpy as jnp
    import godot_whisper_tpu as jgwt
    from godot_whisper_tpu.audio.mel import mel_filterbank
    from godot_whisper_tpu.audio.tokenizer import Tokenizer, synthetic_vocab
    from godot_whisper_tpu.decode.loop import WhisperPipeline
    from godot_whisper_tpu.models.params import init_params
    from godot_whisper_tpu.parallel.batch import BatchTranscriber
    cfg = _nano(jgwt, n_text_layer=3)
    ctx = jgwt.WhisperContext(WhisperPipeline(
        cfg, init_params(cfg, seed=0, compute_dtype=jnp.float32),
        Tokenizer(cfg, synthetic_vocab(cfg)), mel_filterbank(80),
        n_loaded=1))
    n = max(sum(c) for c in list(COUNTS.values()) + [TP_COUNTS])
    segs = BatchTranscriber(ctx).transcribe(
        [make_clip(g) for g in range(n)],
        jgwt.TranscribeParams(best_of=1, temperature_inc=0.0))
    return [_segs(s) for s in segs]


@pytest.mark.parametrize("name", list(COUNTS) + ["tp2"])
def test_multi_process_batch_matches_jax(batch_run, jax_batch, name):
    """Every process gets segments for exactly its local clips, equal to
    the JAX single-process BatchTranscriber's for the same global clips
    (at tp 2 both ranks decode the group's clips [2, 1] together)."""
    counts = TP_COUNTS if name == "tp2" else COUNTS[name]
    for rank, res in enumerate(batch_run):
        base = sum(counts[:rank])
        got = res[name]
        assert len(got) == counts[rank]
        for i, segs in enumerate(got):
            assert segs == jax_batch[base + i], (name, rank, i)
    assert all(jax_batch[i] for i in range(sum(counts)))


def test_tp_group_gathers_its_clips_alone(batch_run):
    """The clips go over the tp group's own gloo group (their traffic
    grows with tp, not with the world); the counts and the frame
    capacity over every rank.  At tp 1 nothing gathers clips."""
    for res in batch_run:
        assert res["gathers_tp2"] == [["host", False], ["tp", True]]
        assert res["gathers_tp1"] == [["host", False]]


def test_stream_mesh_tp_must_divide_local_world(batch_run):
    """Two processes on one host: tp 4 raises before any group is made."""
    for res in batch_run:
        assert "must divide the local world size 2" in res["tp4_error"]


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    tw.run_workers(SCRIPT, "train", 4, out, timeout=300)
    trees = {}
    for name in ("grads", "params", "mu", "nu"):
        for d in range(2):
            with np.load(out / f"{name}_dp{d}.npz") as z:
                trees[name, d] = dict(z)
    with open(out / "train.json") as f:
        return json.load(f), trees


@pytest.fixture(scope="module")
def jax_train():
    import jax
    import jax.numpy as jnp
    import godot_whisper_tpu as jgwt
    from godot_whisper_tpu.models import training as jt
    from godot_whisper_tpu.models.params import init_params
    cfg = _nano(jgwt, n_audio_ctx=64)
    batch = {k: jnp.asarray(v) for k, v in _train_batch(cfg).items()}
    params = init_params(cfg, seed=3, compute_dtype=jnp.float32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, cfg, batch["mel"], batch["tokens"],
                             batch["targets"], batch["mask"])))(params)
    step = jax.jit(lambda s, b: jt.train_step(s, cfg, b, lr=LR))
    states = [jt.init_train_state(params, lr=LR)]
    for _ in range(2):
        states.append(step(states[-1], batch)[0])
    return float(loss), grads, states


def _flat_np(tree):
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_dp_tp_loss_and_grads_match_jax(train_run, jax_train):
    """The global masked mean on every rank, and every gradient leaf
    (unsharded from the tp ranks of each dp shard, the shards equal)
    within 1e-5 of the leaf's largest element."""
    res, trees = train_run
    jloss, jgrads, _ = jax_train
    for loss in res["loss"]:
        assert abs(loss - jloss) <= LOSS_F32 * abs(jloss)
    want = _flat_np(jgrads)
    assert set(want) == set(trees["grads", 0])
    for key, w in want.items():
        for d in range(2):
            got = trees["grads", d][key]
            err = np.abs(got - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= GRAD_F32, (key, d, err)


def test_dp_tp_two_steps_match_jax(train_run, jax_train):
    """mu and nu after two steps within 1e-5 of each leaf's largest
    element, the params within the one-process test's tolerance (Adam's
    update moved by the moments' error, summed over the steps); the loss
    falls on the repeated batch."""
    res, trees = train_run
    _, _, states = jax_train
    adam = states[2].opt_state[0]
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        for key, w in _flat_np(tree).items():
            got = trees[name, 0][key]
            err = np.abs(got - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= MOMENT_F32, (name, key, err)
    tol = {}
    for s in states[1:]:
        adam = s.opt_state[0]
        c = int(adam.count)
        mu, nu = _flat_np(adam.mu), _flat_np(adam.nu)
        for key in mu:
            t = LR * (1e-4 + 2 * MOMENT_F32 * np.abs(mu[key]).max()
                      / (1 - 0.9 ** c)
                      / (np.sqrt(nu[key] / (1 - 0.999 ** c)) + 1e-8))
            tol[key] = tol.get(key, 0) + t
    for key, w in _flat_np(states[2].params).items():
        for d in range(2):
            got = trees["params", d][key]
            assert (np.abs(got - w) <= tol[key] + 2 * np.spacing(
                np.abs(w))).all(), (key, d)
    for steps in res["steps"]:
        assert steps == res["steps"][0] and steps[1] < steps[0]


# ================================================================ the CLI ==
@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """Pico as F32 ggml (2 heads), three WAVs of ragged lengths."""
    from godot_whisper_tpu_torch.audio.mel import mel_filterbank
    from godot_whisper_tpu_torch.audio.tokenizer import synthetic_vocab
    from godot_whisper_tpu_torch.audio.wav import write_wav
    from godot_whisper_tpu_torch.models import loader_ggml
    from godot_whisper_tpu_torch.models.export_ggml import export_checkpoint
    root = tmp_path_factory.mktemp("cli")
    cfg = gt.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=1, n_audio_state=64, n_audio_head=2,
        n_text_state=64, n_text_head=2, name="pico")
    params = gt.init_params(cfg, seed=0, compute_dtype=torch.float32,
                            device="cpu")
    ln, eot = params["decoder"]["ln"], params["decoder"]["token_embed"][
        cfg.token_eot]
    ln["g"] = ln["g"] * 30.0
    ln["b"] = ln["b"] + 35.0 * eot / torch.sum(eot * eot)
    model = str(root / "pico.bin")
    export_checkpoint(model, params, cfg, mel_filterbank(80),
                      synthetic_vocab(cfg), ttype=loader_ggml.GGML_TYPE_F32)
    wavs = root / "wavs"
    wavs.mkdir()
    for i, (sec, f0) in enumerate(((2.0, 220.0), (1.4, 300.0),
                                   (2.6, 180.0))):
        t = np.arange(int(sec * 16000)) / 16000.0
        write_wav(str(wavs / f"c{i}.wav"),
                  (0.3 * np.sin(2 * np.pi * f0 * t)
                   + 0.2 * np.sin(2 * np.pi * 447.0 * t)).astype(np.float32))
    return model, wavs


def _read_dir(d):
    return {n: open(os.path.join(d, n)).read() for n in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def cli_single(cli_files, tmp_path_factory):
    from godot_whisper_tpu_torch.cli import batch as port_batch
    model, wavs = cli_files
    out = tmp_path_factory.mktemp("cli_single")
    assert port_batch.main([str(wavs), "-m", model, "-b", "2",
                            "--output-format", "srt", "--device", "cpu",
                            "-o", str(out)]) == 0
    return _read_dir(out)


@pytest.mark.parametrize("tp", [1, 2])
def test_batch_cli_two_processes(cli_files, cli_single, tmp_path, tp):
    """``gwt-batch`` in two processes (one coordinator address, a process
    id each, gloo named; at tp 2 one tp group) writes the single-process
    CLI's files byte for byte."""
    model, wavs = cli_files
    port = tw.free_port()
    out = tmp_path / "out"
    cmds = [[sys.executable, "-m", "godot_whisper_tpu_torch.cli.batch",
             str(wavs), "-m", model, "-b", "2", "--output-format", "srt",
             "--device", "cpu", "-o", str(out),
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(i), "--tp", str(tp), "--backend", "gloo"]
            for i in range(2)]
    tw.run_procs(cmds, str(tmp_path), timeout=300)
    got = _read_dir(out)
    assert got == cli_single
    assert len(got) == 3 and all(got.values())


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker_main(sys.argv)
