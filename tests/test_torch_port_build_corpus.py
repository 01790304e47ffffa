"""PyTorch port, the corpus tool (``<port>/build_corpus.py``) against the JAX package's
``tools/build_corpus.py``.

(a) the same flags write the same bytes: every ``.npy`` shard, ``eval.npy`` and
    ``corpus.json``, for ``--synthetic-chars`` and for a list of files, and the same
    printed line;
(b) the port rebuilds the committed ``tests/fixtures/corpus_tiny`` from the tool's own
    recipe, byte for byte;
(c) the port's ``data/stream.py`` reads what the port writes (meta, eval split, loader);
(d) the refusals are the JAX tool's (too short a stream, an eval fraction that leaves no
    train row, inputs and ``--synthetic-chars`` together).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu_torch import build_corpus
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import stream

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "corpus_tiny"
# tools/build_corpus.py's docstring: the recipe of the committed fixture
FIXTURE_RECIPE = ["--seq-len", "64", "--shard-sequences", "48", "--eval-frac", "0.2",
                  "--synthetic-chars", "12000", "--synthetic-seed", "7"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_build_corpus", ROOT / "tools" / "build_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(path: pathlib.Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def _text_inputs(tmp_path: pathlib.Path) -> list[str]:
    """Three files made from a numpy seed: ASCII prose-like bytes, raw bytes over the whole
    0..255 range, and an empty file (joined with newlines, as the tool joins them)."""
    rng = np.random.default_rng(22)
    words = np.array([b"fleet", b"canary", b"token", b"shard", b"\n", b". "], dtype=object)
    paths = []
    for name, data in (
            ("a.txt", b" ".join(rng.choice(words, 900))),
            ("b.bin", rng.integers(0, 256, 3001, dtype=np.uint8).tobytes()),
            ("c.txt", b"")):
        path = tmp_path / name
        path.write_bytes(data)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("flags", [
    ["--seq-len", "64", "--shard-sequences", "16", "--eval-frac", "0.1",
     "--synthetic-chars", "9000", "--synthetic-seed", "3"],
    ["--seq-len", "128", "--shard-sequences", "7", "--eval-frac", "0",
     "--synthetic-chars", "5000"],
    ["--seq-len", "32", "--shard-sequences", "1000", "--eval-frac", "0.5",
     "--synthetic-chars", "4001", "--synthetic-seed", "11"],
    "files:--seq-len 48 --shard-sequences 20 --eval-frac 0.15",
    "files:--seq-len 256 --shard-sequences 3 --eval-frac 0.25",
], ids=["synthetic-eval", "synthetic-no-eval", "synthetic-one-shard", "files", "files-long"])
def test_port_writes_the_jax_tools_bytes(tmp_path, capsys, flags):
    if isinstance(flags, str):
        flags = _text_inputs(tmp_path) + flags.split(":", 1)[1].split()
    jax_tool = _jax_tool()
    assert jax_tool.main(["--out", str(tmp_path / "jax"), *flags]) == 0
    jax_line = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    assert build_corpus.main(["--out", str(tmp_path / "port"), *flags]) == 0
    port_line = capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT")
    assert port_line == jax_line and port_line.startswith("wrote OUT: ")
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert list(got) == list(want) and "corpus.json" in got
    for name in want:
        assert got[name] == want[name], name


def test_port_rebuilds_the_committed_fixture(tmp_path):
    out = tmp_path / "corpus"
    assert build_corpus.main(["--out", str(out), *FIXTURE_RECIPE]) == 0
    assert _tree(out) == _tree(FIXTURE)


def test_port_stream_reads_what_the_port_writes(tmp_path):
    out = str(tmp_path / "corpus")
    assert build_corpus.main(["--out", out, "--seq-len", "64", "--shard-sequences", "10",
                              "--eval-frac", "0.2", "--synthetic-chars", "6000"]) == 0
    meta = stream.load_meta(out)
    assert (meta["vocab"], meta["seq_len"], meta["tokenizer"]) == (256, 64, "byte")
    n = 6000 // 64
    n_eval = int(np.ceil(0.2 * n))
    assert [s["sequences"] for s in meta["shards"]] == [10] * 7 + [n - n_eval - 70]
    ev = stream.eval_tokens(out)
    rows = build_corpus.pack_stream(build_corpus.synthetic_text(6000, 0), 64)
    assert ev.dtype == np.int32 and np.array_equal(ev, rows[n - n_eval:])
    loader = stream.StreamLoader(out, 8, seed=1)
    batches = list(loader.iter_batches(0))
    assert len(batches) == loader.batches_per_epoch == (n - n_eval) // 8
    seen = np.concatenate(batches)
    # every train row appears at most once an epoch, and nothing of the eval split
    train = {r.tobytes() for r in rows[:n - n_eval].astype(np.int32)}
    assert len({r.tobytes() for r in seen}) == len(seen)
    assert all(r.tobytes() in train for r in seen.astype(np.int32))


@pytest.mark.parametrize("flags, code", [
    (["--seq-len", "64", "--synthetic-chars", "63"], "fewer than one sequence"),
    (["--seq-len", "64", "--eval-frac", "1.0", "--synthetic-chars", "640"],
     "nothing to train on"),
    (["--seq-len", "1", "--synthetic-chars", "640"], 2),
    (["--shard-sequences", "0", "--synthetic-chars", "640"], 2),
    (["--synthetic-chars", "640", "README.md"], 2),
    ([], 2),
], ids=["short", "all-eval", "seq-len", "shard-sequences", "both-inputs", "no-inputs"])
def test_refusals_are_the_jax_tools(tmp_path, capsys, flags, code):
    outcomes = []
    for main in (_jax_tool().main, build_corpus.main):
        with pytest.raises(SystemExit) as err:
            main(["--out", str(tmp_path / "c"), *flags])
        outcomes.append((err.value.code, capsys.readouterr().err.split("error:")[-1]))
    assert outcomes[0] == outcomes[1]
    if isinstance(code, str):
        assert code in str(outcomes[1][0])
    else:
        assert outcomes[1][0] == code
