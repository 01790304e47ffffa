"""PyTorch port, the pixel-LM trainer (``train/lm.py``) and its parts against the JAX
package's: ``LMConfig``, the LM's training step, remat, the LM checkpoints, the test NLL,
the trainer end to end (resume, the cursor rules, the CLI), a gloo world of 2, and the
port's ``bench_lm``.

Small sizes: embed 32, 1-2 layers, seq 64 from ``tests/fixtures/corpus_tiny`` (vocab 256 +
BOS) or seq 784 on a truncated synthetic MNIST split. Every input comes from a numpy seed or
the committed corpus. Tolerances: eight AdamW steps (clip 1.0, label smoothing 0.1) from
the JAX package's initial parameters within 1e-5 in every loss, parameter and moment (f32
sums in another order, compounded over eight updates); the test NLL within 1e-5 relative;
remat against no remat bitwise (the same operations recomputed); checkpoint files byte for
byte and restored bitwise both ways; a resumed run against the straight run bitwise (the
same operations on the CPU); a gloo world of 2 against world 1 within 1e-5 (the reduce
averages two half-batch gradients where world 1 averages one batch).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import stream as jax_stream
from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.ops import optim as jax_optim
from csed_514_project_distributed_training_using_pytorch_tpu.train import lm as jax_lm_train
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    checkpoint as jax_checkpoint,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import bench_lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist, stream
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
    transformer,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    mesh as mesh_mod,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "fixtures", "corpus_tiny")
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
ATOL = 1e-5
TINY = dict(vocab_size=257, seq_len=64, embed_dim=32, num_layers=2, num_heads=4)
STEPS, BATCH = 8, 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's trainers: the suite runs several workers on
    the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _corpus_batches():
    """``[STEPS, BATCH, 64]`` int32 token batches: the corpus's epoch-0 stream."""
    tokens = stream.StreamLoader(CORPUS, BATCH, seed=0).epoch_tokens(0)
    return tokens[:STEPS * BATCH].reshape(STEPS, BATCH, 64)


# -- the config -------------------------------------------------------------------------


def test_lm_config_is_the_jax_packages_and_refuses_the_unported(monkeypatch):
    ours = {f.name: f.default for f in dataclasses.fields(config.LMConfig)}
    assert ours.pop("device") == "cuda"
    theirs = {f.name: f.default for f in dataclasses.fields(jax_config.LMConfig)}
    assert list(ours) == list(theirs) and ours == theirs
    cfg = config.parse_config(config.LMConfig, [
        "--epochs", "1", "--remat", "--remat-policy", "save-dots", "--device", "cpu",
        "--corpus", CORPUS, "--kv-heads", "2", "--no-rope"])
    assert (cfg.epochs, cfg.remat, cfg.remat_policy, cfg.device, cfg.kv_heads) == (
        1, True, "save-dots", "cpu", 2)
    with pytest.raises(SystemExit):
        config.parse_config(config.LMConfig, ["--epoch", "1"])    # no abbreviations
    base = config.LMConfig(device="cpu")
    for kw, match in ((dict(health_stats=True), "pass --telemetry PATH too"),
                      (dict(zigzag_attention=True), "needs a seq axis"),
                      (dict(grad_accum=0), "grad_accum"), (dict(kv_heads=3), "kv-heads"),
                      (dict(remat_policy="save-dots"), "add --remat"),
                      (dict(attention_window=-1), "window")):
        with pytest.raises(ValueError, match=match):
            lm_train.main(dataclasses.replace(base, **kw))
    # data beside seq and the model axis train now: at a world of 1 the grid refuses them
    # with the JAX package's make_mesh words, as it does any product other than the world
    for mesh, match in (("data=2,seq=2", "requested 4 devices, have 1"),
                        ("data=1,model=2", "requested 2 devices, have 1"),
                        ("data=2", "requested 2 devices, have 1"),
                        ("seq=2", "needs a data axis"),
                        ("data=1,stage=2", "needs a data axis")):
        with pytest.raises(ValueError, match=match):
            mesh_mod.ProcessGrid(lm_train.lm_mesh(mesh, 1))
    assert lm_train.lm_mesh("", 3) == "data=3"
    assert lm_train.lm_mesh("data=1,seq=2", 2, zigzag=True) == "data=1,seq=2"
    assert mesh_mod.ProcessGrid("data=1,seq=1,model=1").world == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):      # the default: the card
        lm_train.main(config.LMConfig())


# -- the step ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """Eight JAX AdamW steps (clip 1.0, label smoothing 0.1, dropout off) from the JAX
    package's init: its model, initial and final states and per-step losses."""
    jm = jax_lm.TransformerLM(**TINY)
    opt = jax_optim.make_optimizer("adamw", learning_rate=1e-3, momentum=0.5,
                                   weight_decay=0.01)
    init = jax_step.create_train_state(jm, jax.random.PRNGKey(0), sample_input_shape=(1, 64),
                                       optimizer=opt)

    def loss_fn(params, xs, ys, rng):
        return jax_lm.next_token_loss(jm, params, xs, rng, deterministic=True,
                                      label_smoothing=0.1)

    train_step = jax.jit(jax_step.make_train_step(
        jm, learning_rate=1e-3, momentum=0.5, optimizer=opt, clip_grad_norm=1.0,
        loss_fn=loss_fn))
    state, losses = init, []
    for xs in _corpus_batches():
        state, loss = train_step(state, jnp.asarray(xs), jnp.zeros(BATCH, jnp.int32),
                                 jax.random.PRNGKey(1))
        losses.append(float(loss))
    return jm, jax.device_get(init), jax.device_get(state), losses


def _port_step(model, **kw):
    """The trainer's step, ``train.lm.make_lm_step``, at the JAX run's settings (the
    defaults' AdamW 1e-3 and clip 1.0, label smoothing 0.1); ``kw`` are ``LMConfig``
    fields."""
    cfg = config.LMConfig(label_smoothing=0.1, dropout_rate=model.dropout_rate, **kw)
    opt = lm_train.lm_optimizer(cfg)
    return opt, lm_train.make_lm_step(model, cfg, optimizer=opt, steps_per_epoch=STEPS)


def _assert_close_tree(ours: dict, theirs, what: str):
    want = transformer.params_from_jax(theirs)
    assert ours.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(ours[k].numpy(), want[k].numpy(), atol=ATOL, rtol=0,
                                   err_msg=f"{what} {k}")


def test_eight_adamw_steps_match_jax(jax_run):
    _, init, final, jax_losses = jax_run
    model = lm.TransformerLM(**TINY)
    opt, train_step = _port_step(model)
    params = transformer.params_from_jax(init.params)
    state = step.TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int64))
    zeros = torch.zeros(BATCH, dtype=torch.int64)
    for i, xs in enumerate(_corpus_batches()):
        state, loss = train_step(state, torch.from_numpy(xs), zeros, 1)
        np.testing.assert_allclose(loss.item(), jax_losses[i], atol=ATOL, rtol=0,
                                   err_msg=f"loss at step {i}")
    assert int(state.step) == STEPS and int(state.velocity["count"]) == STEPS
    _assert_close_tree(state.params, final.params, "params")
    _assert_close_tree(state.velocity["m"], final.velocity["m"], "m")
    _assert_close_tree(state.velocity["v"], final.velocity["v"], "v")
    assert jax_losses[-1] < jax_losses[0]


@pytest.mark.parametrize("policy", ["recompute-all", "save-dots"])
def test_remat_is_bitwise_the_run_without_it_and_recomputes(policy, monkeypatch):
    """Dropout 0.1 (the masks redrawn in the recomputation from the step's key) and two
    microbatches: losses and parameters bitwise; each block runs twice a microbatch."""
    calls = []
    forward = transformer.TransformerBlock.forward
    monkeypatch.setattr(transformer.TransformerBlock, "forward",
                        lambda self, *a: calls.append(1) or forward(self, *a))
    batches = torch.from_numpy(_corpus_batches()[:2])
    zeros = torch.zeros(BATCH, dtype=torch.int64)
    runs = {}
    for remat in (False, True):
        model = lm.TransformerLM(**TINY, dropout_rate=0.1, remat=remat,
                                 remat_policy=policy if remat else "")
        opt, train_step = _port_step(model, grad_accum=2)
        state = step.create_train_state(model, torch.Generator().manual_seed(3),
                                        optimizer=opt)
        calls.clear()
        losses = []
        for xs in batches:
            state, loss = train_step(state, xs, zeros, 5)
            losses.append(loss)
        runs[remat] = (torch.stack(losses), state.params, len(calls))
    (l0, p0, c0), (l1, p1, c1) = runs[False], runs[True]
    assert c0 == 2 * 2 * 2 and c1 == 2 * c0      # steps x microbatches x layers, then twice
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_remat_refuses_a_generator_that_cannot_replay_its_masks():
    model = lm.TransformerLM(**TINY, dropout_rate=0.1, remat=True)
    params = model.init(torch.Generator().manual_seed(0))
    ids = torch.zeros(2, 64, dtype=torch.int64)
    with pytest.raises(ValueError, match="DropoutStream"):
        torch.func.functional_call(model, params, (ids,), {
            "deterministic": False, "generator": torch.Generator().manual_seed(0)})


def test_eval_nll_matches_jax(jax_run):
    jm, _, final, _ = jax_run
    tokens = stream.eval_tokens(CORPUS)[:36]
    want = float(jax.jit(jax_lm_train.make_eval_nll_fn(jm, batch_size=12))(
        final.params, jnp.asarray(tokens)))
    model = lm.TransformerLM(**TINY)
    got = lm_train.make_eval_nll_fn(model, batch_size=12)(
        transformer.params_from_jax(final.params), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        lm_train.make_eval_nll_fn(model, batch_size=10)(
            transformer.params_from_jax(final.params), torch.from_numpy(tokens))


# -- checkpoints ------------------------------------------------------------------------


def _jax_lm_state(ema: bool, seed: int = 0):
    """A JAX LM ``TrainState`` (AdamW) with its moments, count, step and EMA filled from a
    numpy seed."""
    jm = jax_lm.TransformerLM(**TINY)
    opt = jax_optim.make_optimizer("adamw", learning_rate=1e-3, momentum=0.5)
    init = jax_step.create_train_state(jm, jax.random.PRNGKey(seed), sample_input_shape=(1, 64),
                                       optimizer=opt, ema=ema)
    rng = np.random.default_rng(seed)
    noise = lambda tree: jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), jax.device_get(tree))
    velocity = {"count": np.asarray(rng.integers(1, 1000), np.int32),
                "m": noise(init.params), "v": jax.tree_util.tree_map(np.abs, noise(init.params))}
    return jax_step.TrainState(jax.device_get(init.params), velocity,
                               np.asarray(rng.integers(1, 10 ** 6), np.int32),
                               noise(init.params) if ema else None, None)


def _port_reference(ema: bool):
    model = lm.TransformerLM(**TINY)
    opt = optim.make_optimizer("adamw", learning_rate=1e-3, momentum=0.5)
    return step.create_train_state(model, torch.Generator().manual_seed(9), optimizer=opt,
                                   ema=ema)


def _assert_state_is(pstate, jstate):
    for ours, theirs in ((pstate.params, jstate.params),
                         (pstate.velocity["m"], jstate.velocity["m"]),
                         (pstate.velocity["v"], jstate.velocity["v"])) + (
            ((pstate.ema, jstate.ema),) if jstate.ema is not None else ()):
        want = transformer.params_from_jax(theirs)
        for k in want:
            assert torch.equal(ours[k], want[k]), k
    assert int(pstate.step) == int(jstate.step)
    assert int(pstate.velocity["count"]) == int(jstate.velocity["count"])


@pytest.mark.parametrize("ema", [False, True], ids=["plain", "ema"])
def test_lm_checkpoints_are_the_jax_packages_bytes_both_ways(tmp_path, ema):
    jstate = _jax_lm_state(ema)
    jpath, ppath = str(tmp_path / "jax_model_lm.ckpt"), str(tmp_path / "model_lm.ckpt")
    jax_checkpoint.save_train_state(jpath, jstate)
    pstate = checkpoint.restore_train_state(jpath, _port_reference(ema))   # port reads JAX
    _assert_state_is(pstate, jstate)
    checkpoint.save_train_state(ppath, pstate)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()          # the same bytes
    back = jax_checkpoint.restore_train_state(ppath, jstate)              # JAX reads port
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the serving loader takes the LM's train-state file in both packages
    params = checkpoint.load_params_or_state(ppath, _port_reference(False).params)
    want = jax_checkpoint.load_params_or_state(ppath, jstate.params)
    for k, v in transformer.params_from_jax(want).items():
        assert torch.equal(params[k], v), k


# -- the trainer ------------------------------------------------------------------------


def _mnist_pair(n_train=64, n_test=20):
    xs, ys = mnist._synthesize_split(n_train, 50)
    train = mnist.Dataset(mnist._normalize(xs), ys.astype(np.int32), "synthetic")
    xs, ys = mnist._synthesize_split(n_test, 51)
    return train, mnist.Dataset(mnist._normalize(xs), ys.astype(np.int32), "synthetic")


def _mnist_config(tmp_path, **kw):
    return config.LMConfig(**{**dict(
        epochs=2, batch_size=32, eval_batch=20, embed_dim=32, num_layers=1, num_heads=2,
        generate=1, device="cpu", results_dir=str(tmp_path / "results"),
        images_dir=str(tmp_path / "images")), **kw})


def test_train_lm_end_to_end_with_resume_and_cursor_rules(tmp_path, capsys):
    """``tests/test_lm.py``'s trainer test: the loss falls, the per-epoch checkpoint is
    written, a resume from the final one runs no step. Then a resume from the epoch-1 store
    file finishes bitwise the straight run, and a cursor that disagrees with the config
    warns."""
    data = _mnist_pair()
    cfg = _mnist_config(tmp_path, keep_checkpoints=2)
    state, hist = lm_train.main(cfg, datasets=data)
    assert hist.train_losses[-1] < hist.train_losses[0]
    assert hist.test_losses[-1] < hist.test_losses[0] < np.log(17)
    assert int(state.step) == 2 * (64 // 32)
    results = tmp_path / "results"
    assert (results / "model_lm.ckpt").exists() and (results / "metrics.jsonl").exists()
    out = capsys.readouterr().out
    assert "Segment program: eager on cpu" in out and "Epoch 1: train_loss:" in out
    state2, _ = lm_train.main(dataclasses.replace(
        cfg, resume_from=str(results / "model_lm.ckpt"), generate=0), datasets=data)
    assert int(state2.step) == int(state.step)
    assert "starting epoch 2" in capsys.readouterr().out
    # the store's epoch-1 file and its cursor: the resume replays epoch 1 bitwise
    man = checkpoint.load_manifest(str(results / "checkpoints"))
    first = man["entries"][0]
    assert first["cursor"] == {"version": 1, "kind": "epoch", "seed": 1, "epoch": 1,
                               "batch": 0, "step": 2}
    resumed, _ = lm_train.main(dataclasses.replace(
        cfg, resume_from=str(results / "checkpoints" / first["file"]), generate=0,
        results_dir=str(tmp_path / "r2"), keep_checkpoints=0), datasets=data)
    for k in state.params:
        assert torch.equal(resumed.params[k], state.params[k]), k
    for k in state.velocity["m"]:
        assert torch.equal(resumed.velocity["m"][k], state.velocity["m"][k]), k
    capsys.readouterr()
    lm_train.main(dataclasses.replace(          # epochs=1: the check alone, no training
        cfg, seed=2, epochs=1, resume_from=str(results / "checkpoints" / first["file"]),
        generate=0, results_dir=str(tmp_path / "r3"), keep_checkpoints=0), datasets=data)
    assert "WARNING: resume cursor mismatch" in capsys.readouterr().out


def test_corpus_training_stamps_and_verifies_the_stream_cursor(tmp_path):
    """``--corpus``: the manifest holds the loader's cursor (the JAX package's, for the same
    corpus), a resume from it equals the straight run bitwise, and a corpus edited under
    the checkpoint raises."""
    cfg = config.LMConfig(epochs=2, batch_size=16, embed_dim=32, num_layers=1, num_heads=2,
                          corpus=CORPUS, keep_checkpoints=3, device="cpu",
                          results_dir=str(tmp_path / "a"), images_dir=str(tmp_path / "img"))
    straight, hist = lm_train.main(cfg)
    assert hist.train_losses[-1] < hist.train_losses[0]
    assert len(hist.data_wait_seconds) == 2
    store = tmp_path / "a" / "checkpoints"
    entry = checkpoint.load_manifest(str(store))["entries"][0]
    assert entry["cursor"] == jax_stream.StreamLoader(CORPUS, 16, seed=1).cursor(1, 0)
    assert checkpoint.cursor_for(str(store / entry["file"])) == entry["cursor"]
    resumed, _ = lm_train.main(dataclasses.replace(
        cfg, resume_from=str(store / entry["file"]), results_dir=str(tmp_path / "b"),
        keep_checkpoints=0))
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
    edited = tmp_path / "corpus"
    shutil.copytree(CORPUS, edited)
    meta = json.loads((edited / "corpus.json").read_text())
    meta["shards"] = meta["shards"][::-1]               # another plan under the cursor
    (edited / "corpus.json").write_text(json.dumps(meta))
    with pytest.raises(stream.CorpusError, match="mismatch"):
        lm_train.main(dataclasses.replace(
            cfg, corpus=str(edited), resume_from=str(store / entry["file"]),
            results_dir=str(tmp_path / "c"), keep_checkpoints=0))


def test_the_cli_trains_checkpoints_and_samples_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.train.lm", "--device", "cpu", "--epochs", "1",
         "--data-dir", os.path.join(ROOT, "tests", "fixtures", "mnist_idx"),
         "--max-train-examples", "64", "--batch-size", "32", "--max-test-examples", "20",
         "--eval-batch", "20",
         "--embed-dim", "32", "--num-layers", "1", "--num-heads", "2", "--generate", "1",
         "--temperature", "0.8", "--top-k", "5", "--top-p", "0.9"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "data source: idx" in proc.stdout
    assert "Epoch 0: train_loss:" in proc.stdout and "val_ppl" in proc.stdout
    assert (tmp_path / "results" / "model_lm.ckpt").exists()
    lines = (tmp_path / "results" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["kind"] for line in lines] == ["train", "test"]


def test_gloo_world_of_2_matches_world_1(tmp_path):
    """``--mesh data=2`` through the port's launcher (two gloo processes, dropout off)
    against world 1 in this process, on the corpus: every parameter within 1e-5."""
    flags = ["--device", "cpu", "--epochs", "1", "--batch-size", "16", "--embed-dim", "32",
             "--num-layers", "1", "--num-heads", "2", "--corpus", CORPUS]
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.train.launch", "--num-processes", "2", "--timeout",
         "300", "--", "-m", f"{PKG}.train.lm", *flags, "--mesh", "data=2",
         "--results-dir", str(tmp_path / "w2")],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "LM training: 2 process(es) (gloo)" in proc.stdout
    one, _ = lm_train.main(config.parse_config(config.LMConfig, flags + [
        "--results-dir", str(tmp_path / "w1"), "--images-dir", str(tmp_path / "images")]))
    two = checkpoint.restore_train_state(str(tmp_path / "w2" / "model_lm.ckpt"),
                                         step.TrainState(*one))
    assert int(two.step) == int(one.step) == 149 // 16
    for k in one.params:
        np.testing.assert_allclose(two.params[k].numpy(), one.params[k].numpy(), atol=ATOL,
                                   rtol=0, err_msg=k)


def test_bench_lm_prints_the_reference_keys_on_the_cpu(capsys):
    rc = bench_lm.main(["--device", "cpu", "--seq", "64", "--batch", "8", "--gen-batch",
                        "2", "--d-model", "32", "--layers", "1", "--heads", "2",
                        "--steps", "3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    root = open(os.path.join(ROOT, "bench_lm.py")).read()
    keys = {line.strip().split('"')[1] for line in root.splitlines()
            if line.strip().startswith('"') and '":' in line}
    assert keys and keys <= set(out), keys - set(out)
    assert out["platform"] == "cpu" and out["mfu_vs_bf16_peak"] is None
    assert out["train_program"] == "eager" and out["value"] > 0
