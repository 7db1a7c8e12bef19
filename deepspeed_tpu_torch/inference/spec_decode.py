"""Speculative decoding on the paged KV pool — drafters and the acceptance
rule (counterpart of `deepspeed_tpu/inference/spec_decode.py`).

A drafter proposes k tokens a slot; one verify call scores them for every
slot at once (the chunked-prefill machinery at positions pos..pos+k,
`verify_paged_fn`), and the scheduler accepts the longest agreeing prefix
plus one bonus token from the first disagreeing row. Greedy output equals
the decode step's: a draft is accepted only where it is the target's own
greedy choice.

Rejection is free on the paged layout: a rejected draft does not advance
the slot's cursor. Its k/v lies past the cursor, later writes overwrite
it, and nothing reads past the cursor (the paged kernel reads rows
0..pos, the gather's mask stops at each query's position), so there is no
copy, no block free and no table change.

Two drafters, one interface (`Drafter`):

  * `NgramDrafter` — model-free prompt lookup in the slot's own
    prompt + output history: host work only, no device state;
  * `DraftModelDrafter` — a second `DecodeModelSpec` runs k greedy decode
    steps a verify (`build_draft_program`). Its pool mirrors the target's
    block geometry (int8 when the target's is) and is indexed by the SAME
    block tables, so admission, retirement, prefix sharing and rollback
    need no drafter bookkeeping; its prefill shadows the target's chunk
    for chunk.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import params_to


class Drafter:
    """The interface the serving scheduler drives. `propose` returns
    `(drafts [max_slots, k] int32, lens [max_slots] int32)`: `lens[i]`
    counts row i's real proposals (the rest is padding the verify scores
    and acceptance ignores). `prefill_chunk` lets a stateful drafter shadow
    the target's chunked prefill."""

    name = "none"

    def prefill_chunk(self, slot, chunk, start, last_idx, table):
        pass

    def propose(self, dec_slots, tok0, pos, tables
                ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


def ngram_propose(history: np.ndarray, k: int, max_n: int = 4,
                  min_n: int = 1) -> np.ndarray:
    """Prompt-lookup proposal: find the most recent earlier occurrence of
    the history's trailing n-gram (longest n first) and propose the up to k
    tokens that followed it, preferring an occurrence with a full k-token
    continuation. Returns [<=k] int32, empty when no n-gram recurs."""
    L = int(history.shape[0])
    for n in range(min(max_n, L - 1), max(min_n, 1) - 1, -1):
        pat = history[L - n:]
        windows = np.lib.stride_tricks.sliding_window_view(history, n)
        hits = np.nonzero((windows == pat).all(axis=1))[0]
        hits = hits[hits < L - n]
        if hits.size:
            full = hits[hits + n + k <= L]
            start = int(full[-1] if full.size else hits[-1]) + n
            cont = history[start:start + k]
            if cont.size:
                return cont.astype(np.int32)
    return np.zeros((0,), np.int32)


class NgramDrafter(Drafter):
    """Each slot's own prompt + output history is the draft model."""

    name = "ngram"

    def __init__(self, draft_k: int, max_n: int = 4, min_n: int = 1):
        self.k = int(draft_k)
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def propose(self, dec_slots, tok0, pos, tables):
        S = tok0.shape[0]
        drafts = np.zeros((S, self.k), np.int32)
        lens = np.zeros((S,), np.int32)
        for s in dec_slots:
            # the history ends at the slot's last emitted token (the verify
            # input), so the proposal is its continuation
            hist = np.concatenate(
                [s.prompt, np.asarray(s.emitted, np.int32)])
            cont = ngram_propose(hist, self.k, self.max_n, self.min_n)
            drafts[s.idx, :cont.shape[0]] = cont
            lens[s.idx] = cont.shape[0]
        return drafts, lens


def build_draft_program(decode_paged_fn, draft_k: int):
    """The k-step greedy draft loop: feed each slot's last token, run
    `draft_k` paged decode steps with argmax feedback, return the drafts
    [S, k] (on the device: the caller makes the one read) and the pool."""

    def draft_steps(params, tok, pos, pool, tables):
        out = []
        for _ in range(draft_k):
            logits, pool = decode_paged_fn(params, tok, pos, pool, tables)
            tok = logits.argmax(dim=-1).to(torch.int32)
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1), pool

    return draft_steps


class DraftModelDrafter(Drafter):
    """A drafter driven by a second `DecodeModelSpec` whose pool mirrors
    the target's `num_blocks` / `block_size` (int8 when the target's pool
    is) and is indexed by the scheduler's own block tables. A verify costs
    k draft-model decode steps and one read of the drafts."""

    name = "model"

    def __init__(self, serving, draft_spec, draft_k: int):
        missing = [n for n in ("decode_paged_fn", "prefill_paged_fn",
                               "init_paged_pool")
                   if getattr(draft_spec, n, None) is None]
        if missing:
            raise ValueError(
                f"draft model spec '{getattr(draft_spec, 'name', '?')}' has "
                f"no paged serving contract (missing {missing}); build it "
                f"with make_gpt_decode_model")
        self.spec = draft_spec
        self.k = int(draft_k)
        engine = serving.engine
        self.device = engine.device
        self.params = params_to(draft_spec.params, engine.device,
                                engine.dtype)
        name = getattr(draft_spec, "name", "?")
        if serving.kv_quant:
            try:
                pool = draft_spec.init_paged_pool(
                    serving.allocator.num_blocks, serving.block_size,
                    torch.int8, serving.kv_group_size, device=engine.device)
            except TypeError as e:
                raise ValueError(
                    f"draft model spec '{name}' init_paged_pool does not "
                    f"accept the quantized form (num_blocks, block_size, "
                    f"dtype, kv_group_size, device=...) — it does not "
                    f"implement the quantized-pool contract "
                    f"(init_paged_kv_pool in models/gpt.py is the "
                    f"reference): {e}") from e
            if not (isinstance(pool, dict) and "k_scale" in pool):
                raise ValueError(
                    f"draft model spec '{name}' init_paged_pool returned no "
                    f"k_scale/v_scale leaves for dtype int8 — it does not "
                    f"implement the quantized-pool contract")
        else:
            pool = draft_spec.init_paged_pool(
                serving.allocator.num_blocks, serving.block_size,
                engine.dtype, device=engine.device)
        self.pool = pool
        self._draft_steps = build_draft_program(draft_spec.decode_paged_fn,
                                                self.k)

    def _tensor(self, a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def prefill_chunk(self, slot, chunk, start, last_idx, table):
        # the target's chunk, through the same table: the draft logits are
        # discarded, only the draft cache is wanted warm
        _, self.pool = self.spec.prefill_paged_fn(
            self.params, self._tensor(chunk, torch.long),
            self._tensor(start, torch.long),
            self._tensor(last_idx, torch.long), self.pool,
            self._tensor(table, torch.int32))

    def propose(self, dec_slots, tok0, pos, tables):
        drafts, self.pool = self._draft_steps(
            self.params, self._tensor(tok0, torch.int32),
            self._tensor(pos, torch.long), self.pool,
            self._tensor(tables, torch.int32))
        # the drafts' one read: acceptance runs on the host
        drafts = drafts.cpu().numpy()
        lens = np.zeros((tok0.shape[0],), np.int32)
        for s in dec_slots:
            lens[s.idx] = self.k
        return drafts, lens


def make_drafter(serving, cfg, draft_spec=None) -> Optional[Drafter]:
    """The configured drafter of a ServingEngine (None: spec decode off).
    `cfg` is the `ServingConfig.spec_decode` block."""
    kind = str(cfg.drafter or "off")
    if kind == "off":
        return None
    if int(cfg.draft_k) < 1:
        raise ValueError(f"spec_decode.draft_k must be >= 1 when the "
                         f"drafter is on (got {cfg.draft_k})")
    if kind == "ngram":
        return NgramDrafter(cfg.draft_k, max_n=cfg.ngram_max,
                            min_n=cfg.ngram_min)
    if kind == "model":
        if draft_spec is None:
            raise ValueError(
                "spec_decode.drafter='model' needs a draft DecodeModelSpec: "
                "engine.serving(draft_spec=make_gpt_decode_model(...))")
        return DraftModelDrafter(serving, draft_spec, cfg.draft_k)
    raise ValueError(f"unknown spec_decode.drafter {kind!r} "
                     f"(expected 'off', 'ngram' or 'model')")


def accept_greedy(draft_row: np.ndarray, target_row: np.ndarray,
                  draft_len: int) -> Tuple[int, List[int]]:
    """Longest-agreeing-prefix acceptance for one slot: `draft_row` [k]
    proposals, `target_row` [k + 1] the verify's sampled token a position,
    `draft_len` the real proposals. Returns (n accepted, emitted), emitted
    being the accepted drafts plus the bonus token — 1..k+1 tokens, so a
    zero-length draft is exactly a decode step."""
    n = 0
    while n < draft_len and int(draft_row[n]) == int(target_row[n]):
        n += 1
    return n, [int(t) for t in draft_row[:n]] + [int(target_row[n])]
