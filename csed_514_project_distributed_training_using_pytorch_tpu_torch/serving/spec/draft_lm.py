"""Draft-LM drafter: a small ``TransformerLM`` proposes, the target verifies.

Counterpart of the JAX package's ``serving/spec/draft_lm.py``. A cheaper model sharing the
target's tokenizer (the same vocab, ``seq_len`` and BOS) decodes ``k`` tokens ahead
greedily, and the target's ``verify_chunk`` keeps the prefix it agrees with. Where the
n-gram drafter exploits verbatim repetition only, a draft LM can run ahead on anything
the small model predicts as the big one does.

The drafter keeps the engine's discipline on its own state, on the engine's device:

- one greedy draft step (``models.lm.decode_step_slots``, BOS masked, argmax) over the
  whole ``[num_slots]`` batch; proposing ``k`` tokens is ``k + 1`` such steps (the last
  only writes ``d_k``'s row), and the ``[num_slots, k]`` proposals come back to the host
  in one fetch;
- its own contiguous KV cache and ``[num_slots, S]`` prompt buffer; a prompt is installed
  through ``greedy_chunk_plan`` into ``models.lm.prefill_chunk`` (the first chunk wipes the
  recycled slot's planes);
- rollback is position bookkeeping only, as on the target: proposing wrote rows
  ``t .. t+k`` (inputs ``last, d_1 .. d_k``); after the engine accepts some drafts, the
  rows up to the new position hold accepted inputs, and every stale row past it is
  rewritten by the next propose's write-before-attend before a query can read it.
  ``propose_batch`` reads each slot's position off its accepted stream's length.

The JAX drafter runs ``k`` steps and so never writes ``d_k``'s row ``t+k``: after a round
in which every draft is accepted, its next round reads a stale row there (the target's
streams are unaffected; the draft's guesses are worse). The port's extra step writes it,
so the target's own parameters as the draft accept every draft.

Inactive slots ride along at ``S - 1`` (fixed shapes); their writes land on a row that is
rewritten before it can become visible, the engine's own parking argument.
"""

from __future__ import annotations

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm as lm_mod
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    MASK_VALUE,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.spec.drafter import (
    Drafter,
    greedy_chunk_plan,
)


class DraftLMDrafter(Drafter):
    """``model``/``params``: the draft ``models.lm.TransformerLM`` (typically one layer at
    half the embed width) and its flat parameter dict: a trained checkpoint through
    ``utils.checkpoint.load_params_or_state``, or the target's own parameters (the
    perfect-drafter limit). The parameters move to the engine's device, and the buffers
    are made there, at ``bind``."""

    name = "draft-lm"

    def __init__(self, model: lm_mod.TransformerLM, params: dict, *,
                 chunk_sizes: tuple[int, ...] = lm_mod.PREFILL_CHUNK_SIZES):
        self.model = model
        self.params = params
        self._chunk_sizes = tuple(chunk_sizes)
        self.step_calls = 0                      # draft-step invocations
        self.prefill_calls: dict[int, int] = {}  # prompt-install chunks per size
        self._cache: dict | None = None          # made at bind()

    # ------------------------------------------------------------------ lifecycle

    def bind(self, *, num_slots: int, vocab_size: int, seq_len: int,
             device=None) -> None:
        if self.model.vocab_size != vocab_size:
            raise ValueError(
                f"draft LM vocab {self.model.vocab_size} != target {vocab_size} — "
                f"speculation needs a shared tokenizer")
        if self.model.seq_len != seq_len:
            raise ValueError(f"draft LM seq_len {self.model.seq_len} != target {seq_len}")
        sizes = {min(int(c), int(seq_len)) for c in self._chunk_sizes}
        if any(c < 1 for c in sizes):
            raise ValueError(f"draft chunk sizes must be >= 1, got {self._chunk_sizes}")
        self.device = torch.device("cpu" if device is None else device)
        self.num_slots = int(num_slots)
        self.seq_len = int(seq_len)
        self._sizes = tuple(sorted(sizes))
        self.params = {name: p.to(self.device) for name, p in self.params.items()}
        self._cache = lm_mod.init_cache(self.model, self.num_slots, device=self.device)
        self._prompt = torch.zeros((self.num_slots, self.seq_len), dtype=torch.int32,
                                   device=self.device)

    def on_activate(self, slot: int, tokens: list[int]) -> None:
        """Install the slot's stream into the draft cache: one prompt-row copy, then the
        greedy chunk plan through ``prefill_chunk`` (``fresh`` on the first chunk)."""
        p = len(tokens)
        if p == 0:
            return          # nothing cached yet; write-before-attend covers the slot
        row = np.zeros((self.seq_len,), np.int32)
        row[:p] = np.asarray(tokens, np.int32)
        self._prompt[slot] = torch.from_numpy(row).to(self.device)
        with torch.no_grad():
            for start, length, size in greedy_chunk_plan(self._sizes, 0, p):
                self.prefill_calls[size] = self.prefill_calls.get(size, 0) + 1
                lm_mod.prefill_chunk(self.model, self.params, self._cache, self._prompt,
                                     slot, start, length, start == 0, chunk=size)

    # ------------------------------------------------------------------ propose

    def propose_batch(self, entries: list[tuple[int, list[int], int]],
                      k: int) -> list[np.ndarray]:
        """``k`` greedy draft tokens per active slot: ``k + 1`` draft steps over the whole
        batch. Step ``j`` feeds each slot its previous guess at position ``t + j``
        (writing the draft cache's row as it goes), so the proposals are what greedy
        decoding of the draft model would emit next; step ``k`` writes ``d_k``'s row."""
        if self._cache is None:
            raise RuntimeError("DraftLMDrafter.bind() was never called")
        if not entries:
            return []
        ids = np.zeros((self.num_slots,), np.int32)
        t = np.full((self.num_slots,), self.seq_len - 1, np.int32)       # parked
        for slot, tokens, last in entries:
            ids[slot] = last
            t[slot] = min(len(tokens), self.seq_len - 1)
        host = torch.from_numpy(np.stack([ids, t]))
        if self.device.type == "cuda":
            staged = host.pin_memory().to(self.device, non_blocking=True)
        else:
            staged = host.clone()
        ids_d, t_d = staged[0].long(), staged[1].long()
        out = []
        with torch.no_grad():
            for j in range(k + 1):
                self.step_calls += 1
                _, logp = lm_mod.decode_step_slots(
                    self.model, self.params, self._cache, ids_d,
                    (t_d + j).clamp(max=self.seq_len - 1))
                if j == k:
                    break         # the step only wrote d_k's row; its guess is not needed
                logp[:, self.model.vocab_size - 1] = MASK_VALUE
                ids_d = torch.argmax(logp, dim=-1)
                out.append(ids_d)
        drafts = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()   # one fetch
        return [drafts[slot] for slot, _, _ in entries]


__all__ = ["DraftLMDrafter"]
