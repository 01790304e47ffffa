"""Build a sharded token corpus (``data/stream.py`` format) from text files.

The port's counterpart of the JAX package's ``tools/build_corpus.py``, with its flags,
printed line and bytes: the same inputs give the same ``.npy`` shards and the same
``corpus.json``, byte for byte, so the sha256s the loader checks agree whichever package
built the corpus. It works on the host only (numpy and the standard library) and touches
no device.

The streaming loader (``data/stream.py``) consumes a directory of fixed-length
token-sequence shards plus a ``corpus.json`` manifest. This tool is the one producer of
that layout: it byte-level-tokenizes any set of text/binary files (ids 0..255, the
zero-vocabulary-file tokenizer, deterministic by construction), packs the concatenated
stream into ``seq_len`` sequences, reserves a held-out tail as the eval split, and writes
the rest as uint16 ``.npy`` shards with recorded sha256. The loader verifies each shard on
first touch, so a corpus edited under a checkpoint is an error, not a reshuffle.

Everything is deterministic in the inputs: files are processed in the order given (sort
them yourself for path-set stability), packing drops the ragged byte tail, and the eval
split is the LAST ``--eval-frac`` of sequences (no RNG anywhere: shuffling is the loader's
job, keyed by ``(seed, epoch)``).

``--synthetic-chars N`` generates a deterministic pseudo-text stream instead of reading
inputs: the fixture generator (``tests/fixtures/corpus_tiny`` is output of this mode) and
the quick way to exercise the pipeline on a machine with no corpus at hand.

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.build_corpus \\
        --out corpus/ --seq-len 128 --shard-sequences 512 --eval-frac 0.1 \\
        README.md DESIGN.md
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.build_corpus \\
        --out results/corpus_tiny --seq-len 64 --shard-sequences 48 --eval-frac 0.2 \\
        --synthetic-chars 12000 --synthetic-seed 7
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.stream import (
    META_NAME,
)

BYTE_VOCAB = 256


def synthetic_text(chars: int, seed: int) -> bytes:
    """Deterministic pseudo-text: word-ish tokens over a small alphabet with
    punctuation/newlines, enough structure that a byte LM has something to learn, zero
    external inputs."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, chars]))
    words = ["the", "model", "serves", "tokens", "shard", "stream", "epoch",
             "batch", "cursor", "resume", "canary", "promote", "fleet",
             "replica", "goodput", "train", "deploy", "rollback", "manifest",
             "checkpoint"]
    out: list[str] = []
    n = 0
    while n < chars:
        w = words[int(rng.integers(len(words)))]
        sep = "\n" if rng.random() < 0.08 else (". " if rng.random() < 0.1 else " ")
        out.append(w + sep)
        n += len(w) + len(sep)
    return "".join(out).encode("ascii")[:chars]


def pack_stream(stream: bytes, seq_len: int) -> np.ndarray:
    """Byte ids → ``[N, seq_len]`` uint16 sequences, ragged tail dropped."""
    ids = np.frombuffer(stream, dtype=np.uint8).astype(np.uint16)
    n = len(ids) // seq_len
    if n == 0:
        raise SystemExit(f"input stream has {len(ids)} tokens — fewer than one "
                         f"sequence of {seq_len}")
    return ids[:n * seq_len].reshape(n, seq_len)


def _write_npy(path: str, arr: np.ndarray) -> str:
    """Atomic .npy write; returns the sha256 the manifest records."""
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    data = buf.getvalue()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return hashlib.sha256(data).hexdigest()


def build(out_dir: str, sequences: np.ndarray, *, shard_sequences: int,
          eval_frac: float, tokenizer: str = "byte", vocab: int = BYTE_VOCAB) -> dict:
    """Write the corpus directory and return its meta (also written as
    ``corpus.json``). Split rule: the last ``ceil(eval_frac * N)`` sequences are the eval
    split (at least one full train shard must remain)."""
    n = len(sequences)
    n_eval = int(np.ceil(eval_frac * n)) if eval_frac > 0 else 0
    if n - n_eval < 1:
        raise SystemExit(f"--eval-frac {eval_frac} leaves {n - n_eval} train "
                         f"sequences of {n} — nothing to train on")
    train, eval_split = sequences[:n - n_eval], sequences[n - n_eval:]
    os.makedirs(out_dir, exist_ok=True)
    shards = []
    for i, start in enumerate(range(0, len(train), shard_sequences)):
        chunk = train[start:start + shard_sequences]
        name = f"shard_{i:04d}.npy"
        digest = _write_npy(os.path.join(out_dir, name), chunk)
        shards.append({"file": name, "sequences": int(len(chunk)), "sha256": digest})
    meta = {"version": 1, "tokenizer": tokenizer, "vocab": int(vocab),
            "seq_len": int(sequences.shape[1]), "shards": shards, "eval": None}
    if n_eval:
        digest = _write_npy(os.path.join(out_dir, "eval.npy"), eval_split)
        meta["eval"] = {"file": "eval.npy", "sequences": int(n_eval), "sha256": digest}
    tmp = os.path.join(out_dir, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(out_dir, META_NAME))
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="tokenize/pack text files into a sharded token corpus")
    ap.add_argument("inputs", nargs="*", help="text files to tokenize, in order")
    ap.add_argument("--out", required=True, help="corpus output directory")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--shard-sequences", type=int, default=512,
                    help="sequences per shard file")
    ap.add_argument("--eval-frac", type=float, default=0.1,
                    help="held-out tail fraction (0 disables the eval split)")
    ap.add_argument("--synthetic-chars", type=int, default=0,
                    help="generate N chars of deterministic pseudo-text "
                         "instead of reading inputs")
    ap.add_argument("--synthetic-seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.seq_len < 2:
        ap.error(f"--seq-len must be >= 2, got {args.seq_len}")
    if args.shard_sequences < 1:
        ap.error(f"--shard-sequences must be >= 1, got {args.shard_sequences}")
    if bool(args.inputs) == bool(args.synthetic_chars):
        ap.error("pass input files XOR --synthetic-chars")
    if args.synthetic_chars:
        stream = synthetic_text(args.synthetic_chars, args.synthetic_seed)
    else:
        parts = []
        for path in args.inputs:
            with open(path, "rb") as f:
                parts.append(f.read())
        stream = b"\n".join(parts)
    sequences = pack_stream(stream, args.seq_len)
    meta = build(args.out, sequences, shard_sequences=args.shard_sequences,
                 eval_frac=args.eval_frac)
    n_eval = meta["eval"]["sequences"] if meta["eval"] else 0
    print(f"wrote {args.out}: {len(meta['shards'])} shard(s), "
          f"{sum(s['sequences'] for s in meta['shards'])} train + {n_eval} eval "
          f"sequences of seq_len {meta['seq_len']}, vocab {meta['vocab']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
