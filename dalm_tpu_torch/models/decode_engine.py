"""Continuous-batching decode engine (counterpart of ``dalm_tpu/models/decode_engine.py``).

A fixed pool of ``num_slots`` decode slots over one KV cache of length
``L = P + max_new_tokens``: a slot whose request ends (EOS or its budget) is
given to the next waiting request, so a short answer stops paying for a long
one. The schedule is the reference's:

- prompts are LEFT-padded to ``max_prompt_len`` P, so after admission every
  slot's write head starts at cache slot P;
- each slot keeps its own write position; the decoder takes them as a (B,)
  ``cache_index`` and writes each row's keys and values at its own slot
  (``models/decoder.py:_cache_write``);
- admission prefills a wave of prompts into a row cache of length P (in one
  forward, or in ``P / prefill_chunk`` cached column blocks) and copies the
  valid rows into the pool's first P columns; the first token of request
  ``r`` is drawn with request index ``r`` and token index 0;
- a freed slot's stale keys and values need no cleanup: the slot-causal mask
  hides every slot at or past the new request's write head, and each decode
  step writes its own slot before it attends.

``generate`` is the host loop of ``:615-765`` (chunks of ``decode_chunk``
tokens, admission of every free slot, the first tokens read one round late);
``generate_fused`` runs the schedule of the reference's single program
(``:271-560``) as a Python loop: one token per active slot per iteration, an
admission wave once the free slots reach ``min(max(B // 2, 1), remaining)``,
at the pool's full width or in ``admit_width`` rows. The pool (cache, tok,
pos, write_pos, slot_mask) is allocated on first use and changed in place,
which is what the reference's buffer donation buys.

With ``speculative_gamma`` G > 0 every schedule verifies G prompt-lookup
drafts a slot per forward (``models/speculative.py``) and commits 1 to G + 1
tokens a slot: ``generate`` in synchronous rounds whose drafts the host makes
from its own record of each request (``host_draft``, the reference's
``_generate_speculative``, ``:767-866``), ``generate_fused`` with
``prompt_lookup`` over each slot's [prompt | tokens] (``speculative_step``,
``:466-533``), EOS inside an accepted span cutting the commit there. The pool
is G + 1 slots longer, so the last window never writes past its end.

Differences from the reference: the decoder holds its own weights, so the
engine takes no ``params`` or ``extra_collections``; an admission copies only
its valid rows into the pool where the reference scatters invalid ones to slot
B with ``mode="drop"`` (torch raises on that index).
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from dalm_tpu_torch.models.decoder import Decoder
from dalm_tpu_torch.models.sampling import SamplerConfig, resolve, select_token
from dalm_tpu_torch.models.speculative import commit, prompt_lookup


class DecodeEngine:
    def __init__(
        self,
        decoder: Decoder,
        num_slots: int,
        max_prompt_len: int,
        max_new_tokens: int,
        eos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        decode_chunk: int = 8,
        sampler: Optional[SamplerConfig] = None,
        speculative_gamma: int = 0,
        prefill_chunk: Optional[int] = None,
        admit_width: Optional[int] = None,
    ):
        """``decoder`` runs on its own device, with its own (possibly packed)
        weights. ``sampler``: None / temperature 0 is greedy; a draw is keyed
        by (request index, token index), so the lockstep, host-loop and fused
        schedules give the same tokens. ``speculative_gamma``: G > 0 verifies G
        prompt-lookup drafts a slot per forward (rejection sampling with a
        sampler). ``prefill_chunk``: admission in
        cached column blocks of C tokens, C rounded down to the largest
        divisor of P. ``admit_width``: admission waves of W rows (W < B; W ==
        B is the full-width default)."""
        self.decoder = decoder
        self.samp = resolve(sampler)
        self.num_slots = B = num_slots
        self.P = P = max_prompt_len
        self.max_new = max_new_tokens
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.chunk = min(decode_chunk, max_new_tokens)
        self.spec_gamma = G = int(speculative_gamma)
        # + G + 1 slack: the last verify window may run past max_new_tokens
        self.L = max_prompt_len + max_new_tokens + (G + 1 if G else 0)
        if prefill_chunk is None or prefill_chunk >= P:
            self.prefill_C = P  # one-shot prefill
        else:
            C = max(1, int(prefill_chunk))
            while P % C:  # the largest divisor of P not above the request
                C -= 1
            self.prefill_C = C
        if admit_width is not None and not (1 <= admit_width <= B):
            raise ValueError(f"admit_width must be in [1, num_slots]; got {admit_width}")
        self.admit_W = admit_width if (admit_width and admit_width < B) else None
        self.device = next(decoder.parameters()).device
        self._state = None

    @property
    def state(self) -> dict:
        """The pool: ``cache`` (the decoder's buffers, B x L), ``tok``, ``pos``,
        ``write_pos`` (B,) and ``slot_mask`` (B, L), allocated on first use."""
        if self._state is None:
            B, dev = self.num_slots, self.device
            self._state = dict(
                cache=self.decoder.init_kv_cache(B, self.L, device=dev),
                tok=torch.zeros(B, dtype=torch.long, device=dev),
                pos=torch.zeros(B, dtype=torch.long, device=dev),
                write_pos=torch.full((B,), self.P, dtype=torch.long, device=dev),
                slot_mask=torch.zeros((B, self.L), dtype=torch.long, device=dev),
            )
        return self._state

    # ---- device steps ------------------------------------------------------
    def _prefill_rows(self, ids: torch.Tensor, mask: torch.Tensor, positions: torch.Tensor):
        """Admission prefill of (rows, P) prompts: (row cache of length P,
        last-token logits (rows, V)). The row cache is P long, not L."""
        P, C = self.P, self.prefill_C
        rc = self.decoder.init_kv_cache(ids.shape[0], P, device=self.device)
        for c in range(0, P, C):
            logits, rc = self.decoder(ids[:, c:c + C], mask, positions=positions[:, c:c + C], kv_cache=rc,
                                      cache_index=c, logits_last_only=True)
        return rc, logits[:, -1, :]

    def _admit(self, ids: np.ndarray, mask: np.ndarray, slot_ids: np.ndarray, valid: np.ndarray,
               req_ids: np.ndarray) -> torch.Tensor:
        """Prefill (m, P) prompts and copy the ``valid`` rows into pool slots
        ``slot_ids``: cache columns [0, P), tok, pos, write_pos = P and the slot
        mask ``[mask, ones(L - P)]``. Returns the first tokens (m,) on the device,
        request ``req_ids[j]``'s at row j (token index 0)."""
        st, dev = self.state, self.device
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
        mask_t = torch.as_tensor(mask, dtype=torch.long, device=dev)
        positions = torch.clamp(torch.cumsum(mask_t, dim=1) - 1, min=0)
        row_cache, last = self._prefill_rows(ids_t, mask_t, positions)
        req = torch.as_tensor(req_ids, dtype=torch.long)
        first = select_token(last, self.samp, req, torch.zeros_like(req))
        rows = np.flatnonzero(valid)
        if len(rows):
            r = torch.as_tensor(rows, device=dev)
            s = torch.as_tensor(slot_ids[rows], dtype=torch.long, device=dev)
            for name, layer in st["cache"].items():
                for key, big in layer.items():
                    big[s, : self.P] = row_cache[name][key][r].to(big.dtype)
            st["tok"][s] = first[r].long()
            st["pos"][s] = mask_t[r].sum(dim=1)
            st["write_pos"][s] = self.P
            st["slot_mask"][s, : self.P] = mask_t[r]
            st["slot_mask"][s, self.P:] = 1
        return first

    def _step(self, req_ids: torch.Tensor, token_idx: torch.Tensor) -> torch.Tensor:
        """One cached forward of every slot at its own write position; the
        next token of each row (B,) int32, drawn with the given keys."""
        st = self.state
        logits, _ = self.decoder(st["tok"][:, None], st["slot_mask"], positions=st["pos"][:, None],
                                 kv_cache=st["cache"], cache_index=st["write_pos"])
        return select_token(logits[:, 0, :], self.samp, req_ids, token_idx)

    def _advance(self, active: torch.Tensor, tok: torch.Tensor) -> None:
        st = self.state
        act = active.long()
        st["tok"].copy_(tok)
        st["pos"].add_(act)
        st["write_pos"].add_(act)

    def _decode_chunk(self, active: np.ndarray, req_ids: np.ndarray) -> torch.Tensor:
        """``self.chunk`` steps of every slot: (B, chunk) tokens. Inactive slots
        emit pad and do not advance; their writes land on their own stale slots."""
        st = self.state
        act = torch.as_tensor(active, device=self.device)
        req = torch.as_tensor(req_ids, dtype=torch.long)
        toks = []
        for _ in range(self.chunk):
            # token index of the produced token = the count emitted so far
            nxt = self._step(req, st["write_pos"] - self.P + 1)
            nxt = torch.where(act, nxt, torch.full_like(nxt, self.pad))
            self._advance(act, nxt.long())
            toks.append(nxt)
        return torch.stack(toks, dim=1)

    def _verify(self, active: np.ndarray, draft, budget, req_ids, g0) -> tuple:
        """One verify pass of every slot: slot b runs [tok, draft[b]] (G + 1 tokens) from its write head and
        commits ``m[b]`` tokens, at most ``budget[b]`` and none on an inactive slot; its tok, pos and write head
        advance by ``m[b]``. ``req_ids`` / ``g0`` (B,): the request and its tokens so far (the sampling keys).
        Returns ``emit`` (B, G + 1) and ``m`` (B,) on the device; ``emit[b, :m[b]]`` are the committed tokens."""
        st, dev = self.state, self.device
        draft = torch.as_tensor(draft, dtype=torch.long, device=dev)
        G = draft.shape[1]
        logits, _ = self.decoder(torch.cat([st["tok"][:, None], draft], dim=1), st["slot_mask"],
                                 positions=st["pos"][:, None] + torch.arange(G + 1, device=dev)[None, :],
                                 kv_cache=st["cache"], cache_index=st["write_pos"])
        emit, m = commit(logits, draft, self.samp, req_ids, g0, torch.as_tensor(active, device=dev),
                         torch.as_tensor(budget, dtype=torch.long, device=dev))
        last = emit.gather(1, (m - 1).clamp(0, G)[:, None])[:, 0]
        st["tok"].copy_(torch.where(m > 0, last, st["tok"]))
        st["pos"].add_(m)
        st["write_pos"].add_(m)
        return emit, m

    def host_draft(self, history: np.ndarray, ngram: int = 2) -> np.ndarray:
        """Prompt-lookup draft for one request from its 1-D [prompt tokens | emitted tokens] (no pads): the
        (G,) tokens after the most recent earlier occurrence of its last ``ngram`` tokens, padded with the last
        token where the history ends; the last token repeated where there is no such occurrence."""
        G, n = self.spec_gamma, len(history)
        cur = history[n - ngram:]
        for start in range(n - 2 * ngram, -1, -1):  # the most recent earlier occurrence first
            if (history[start:start + ngram] == cur).all():
                d = history[start + ngram:start + ngram + G]
                return np.concatenate([d, np.full(G - len(d), history[-1])]).astype(np.int64)
        return np.full(G, history[-1], np.int64)

    def _prompts(self, input_ids, attention_mask) -> tuple:
        input_ids, attention_mask = np.asarray(input_ids), np.asarray(attention_mask)
        if input_ids.shape != attention_mask.shape or input_ids.ndim != 2 or input_ids.shape[1] != self.P:
            raise ValueError(f"prompts must be (N, {self.P}): left-padded to max_prompt_len; got ids "
                             f"{input_ids.shape}, mask {attention_mask.shape}")
        return input_ids, attention_mask

    def _caps(self, N: int, budgets) -> np.ndarray:
        if budgets is None:
            return np.full(N, self.max_new, np.int64)
        return np.minimum(np.asarray(budgets, np.int64), self.max_new)

    # ---- host loop ---------------------------------------------------------
    @torch.no_grad()
    def generate(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                 budgets: Optional[Sequence[int]] = None) -> List[List[int]]:
        """Decode all prompts with slot recycling. ``input_ids`` /
        ``attention_mask``: (N, P) left-padded, N may exceed ``num_slots``.
        ``budgets`` caps each request's new tokens (at most ``max_new_tokens``;
        0 returns []). Returns per-prompt token lists, EOS excluded, in input
        order."""
        input_ids, attention_mask = self._prompts(input_ids, attention_mask)
        N = input_ids.shape[0]
        caps = self._caps(N, budgets)
        if self.spec_gamma:
            return self._generate_speculative(input_ids, attention_mask, caps)
        B = self.num_slots
        results: List[Optional[List[int]]] = [None] * N
        pending = deque()
        for req in range(N):
            if caps[req] <= 0:
                results[req] = []
            else:
                pending.append(req)
        slot_req = np.full(B, -1, np.int64)  # -1 = free
        slot_toks: List[List[int]] = [[] for _ in range(B)]

        def finish(slot):
            results[slot_req[slot]] = slot_toks[slot]
            slot_req[slot] = -1
            slot_toks[slot] = []

        def admit():
            """Fill the free slots from the queue (at most ``admit_width``) in one prefill; the first tokens
            stay on the device until ``settle``."""
            free = np.flatnonzero(slot_req == -1)
            m = self._wave(len(free), len(pending))
            if m == 0:
                return None
            reqs, slots = [pending.popleft() for _ in range(m)], free[:m]
            first_tok = self._admit_rows(input_ids[reqs], attention_mask[reqs], slots, reqs)
            for req, slot in zip(reqs, slots):
                slot_req[slot] = req  # active from the next decode chunk on
            return reqs, slots, first_tok

        def settle(admission):
            """Bank the first tokens of the previous admission."""
            if admission is None:
                return
            reqs, slots, first_tok = admission
            first_tok = first_tok.cpu().numpy()
            for j, (req, slot) in enumerate(zip(reqs, slots)):
                first = int(first_tok[j])
                if self.eos is not None and first == self.eos:
                    finish(slot)
                else:
                    slot_toks[slot].append(first)
                    if len(slot_toks[slot]) >= caps[req]:
                        finish(slot)

        def harvest(chunk, snapshot):
            """Apply one chunk against the slot -> request map live when it was
            launched; a slot finished or given to another request since is skipped."""
            chunk = chunk.cpu().numpy()
            for slot in np.flatnonzero(snapshot >= 0):
                req = snapshot[slot]
                if results[req] is not None or slot_req[slot] != req:
                    continue
                for t in chunk[slot]:
                    t = int(t)
                    if self.eos is not None and t == self.eos:
                        finish(slot)
                        break
                    slot_toks[slot].append(t)
                    if len(slot_toks[slot]) >= caps[req]:
                        finish(slot)
                        break

        # Every round launches its decode chunk and its admission before it
        # reads the previous round back: a slot freed in round r idles through
        # round r + 1, already launched, and is filled again at r + 2.
        in_flight = None  # (chunk, slot_req snapshot at launch)
        unsettled = admit()
        while True:
            if (slot_req >= 0).any():
                snapshot = slot_req.copy()
                chunk = self._decode_chunk(snapshot >= 0, np.maximum(snapshot, 0))
                next_flight = (chunk, snapshot)
            else:
                next_flight = None
            settle(unsettled)
            if in_flight is not None:
                harvest(*in_flight)
            unsettled = admit()
            in_flight = next_flight
            if in_flight is None and unsettled is None and not pending and not (slot_req >= 0).any():
                break
        return results  # type: ignore[return-value]

    def _wave(self, n_free: int, n_pending: int) -> int:
        """The size of the next admission wave: every free slot a pending request can take, at most
        ``admit_width``."""
        m = min(n_free, n_pending)
        return min(m, self.admit_W) if self.admit_W else m

    def _admit_rows(self, ids: np.ndarray, mask: np.ndarray, slots: np.ndarray, req_ids) -> torch.Tensor:
        """Admit m left-padded (m, P) prompts into pool ``slots`` in one prefill of ``admit_width`` or
        ``num_slots`` rows, request ``req_ids[j]`` at row j: its first tokens (m,) on the device."""
        m, m_pad = len(slots), self.admit_W or self.num_slots
        pad_ids = np.zeros((m_pad, self.P), np.int64)
        pad_mask = np.zeros((m_pad, self.P), np.int64)
        pad_mask[:, -1] = 1  # padding rows: one valid token (a finite forward)
        slot_ids = np.full((m_pad,), self.num_slots, np.int64)
        valid = np.zeros((m_pad,), bool)
        req_arr = np.zeros((m_pad,), np.int64)
        pad_ids[:m], pad_mask[:m], slot_ids[:m], valid[:m], req_arr[:m] = ids, mask, slots, True, req_ids
        return self._admit(pad_ids, pad_mask, slot_ids, valid, req_arr)[:m]

    def _generate_speculative(self, input_ids, attention_mask, caps) -> List[List[int]]:
        """The host loop with verify passes: synchronous rounds (each round's drafts and budgets must see the
        device's true position; a read-back now brings up to G + 1 tokens a slot)."""
        N, B = input_ids.shape[0], self.num_slots
        results: List[Optional[List[int]]] = [[] if caps[r] <= 0 else None for r in range(N)]
        pending = deque(r for r in range(N) if caps[r] > 0)
        slot_req = np.full(B, -1, np.int64)
        slot_toks: List[List[int]] = [[] for _ in range(B)]
        prompts = [input_ids[r][attention_mask[r] > 0] for r in range(N)]

        def finish(slot):
            results[slot_req[slot]] = slot_toks[slot][: caps[slot_req[slot]]]
            slot_req[slot] = -1
            slot_toks[slot] = []

        def bank(slot, toks) -> None:
            """Append committed tokens to a slot's request, up to EOS (excluded) or its budget."""
            for t in toks:
                t = int(t)
                if self.eos is not None and t == self.eos:
                    return finish(slot)
                slot_toks[slot].append(t)
                if len(slot_toks[slot]) >= caps[slot_req[slot]]:
                    return finish(slot)

        while True:
            free = np.flatnonzero(slot_req == -1)
            m = self._wave(len(free), len(pending))
            if m:
                reqs, slots = [pending.popleft() for _ in range(m)], free[:m]
                first = self._admit_rows(input_ids[reqs], attention_mask[reqs], slots, reqs).cpu().numpy()
                for j, (req, slot) in enumerate(zip(reqs, slots)):
                    slot_req[slot] = req
                    bank(slot, first[j:j + 1])
            active = slot_req >= 0
            if not active.any():
                if not pending:
                    break
                continue
            drafts = np.zeros((B, self.spec_gamma), np.int64)
            rem, g0 = np.zeros(B, np.int64), np.zeros(B, np.int64)
            for slot in np.flatnonzero(active):
                req = slot_req[slot]
                history = np.concatenate([prompts[req], np.asarray(slot_toks[slot], np.int64)])
                drafts[slot] = self.host_draft(history)
                rem[slot] = caps[req] - len(slot_toks[slot])
                g0[slot] = len(slot_toks[slot])
            emit, m = self._verify(active, drafts, rem, np.maximum(slot_req, 0), g0)
            emit, m = emit.cpu().numpy(), m.cpu().numpy()
            for slot in np.flatnonzero(active):
                bank(slot, emit[slot, : m[slot]])
        return results  # type: ignore[return-value]

    # ---- the fused schedule ------------------------------------------------
    @torch.no_grad()
    def generate_fused(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                       budgets: Optional[Sequence[int]] = None) -> List[List[int]]:
        """``generate`` on the schedule of the reference's single program: all
        prompts known up front, one token per active slot per iteration, the
        scheduling state on the host and each iteration's tokens read back once."""
        input_ids, attention_mask = self._prompts(input_ids, attention_mask)
        N = input_ids.shape[0]
        caps = self._caps(N, budgets)
        live = np.flatnonzero(caps > 0)
        results: List[List[int]] = [[] for _ in range(N)]
        if len(live) == 0:
            return results
        out, out_len = self._fused(input_ids[live], attention_mask[live], caps[live], live)
        for j, req in enumerate(live):
            results[req] = [int(t) for t in out[j, : out_len[j]]]
        return results

    def _fused(self, input_ids: np.ndarray, attention_mask: np.ndarray, caps: np.ndarray, req_ids: np.ndarray):
        """The reference's ``fused_schedule`` (``:271-553``): one token a slot an
        iteration, or a verify pass with ``speculative_gamma``. ``caps`` (N,)
        budgets, all >= 1; ``req_ids`` (N,) the ORIGINAL request indices (the
        sampling keys). Returns ``out`` (N, max_new) and ``out_len`` (N,)."""
        N, B, P, MN, W, G = input_ids.shape[0], self.num_slots, self.P, self.max_new, self.admit_W, self.spec_gamma
        has_eos = self.eos is not None
        eos = self.eos if has_eos else -1
        st = self.state
        st["tok"].zero_()
        st["pos"].zero_()
        st["write_pos"].fill_(P)
        st["slot_mask"].zero_()
        slot_req = np.full(B, -1, np.int64)
        gen_count = np.zeros(B, np.int64)
        next_req = 0
        out = np.full((N, MN), self.pad, np.int64)
        out_len = np.zeros(N, np.int64)
        req_t = torch.as_tensor(req_ids, dtype=torch.long)

        def admit():
            """One wave: at full width, row i prefills for slot i if it is free
            (the ``rank``-th free slot takes request ``next_req + rank``); with
            ``admit_width`` W, the first W free slots take the next W requests."""
            nonlocal next_req
            free = slot_req < 0
            if W:
                slots = np.full(W, B, np.int64)
                first_free = np.flatnonzero(free)[:W]
                slots[: len(first_free)] = first_free
                req_idx = next_req + np.arange(W)
                take = (slots < B) & (req_idx < N)
            else:
                slots = np.arange(B)
                req_idx = next_req + np.cumsum(free) - 1
                take = free & (req_idx < N)
            safe = np.clip(req_idx, 0, N - 1)
            mask = np.where(take[:, None], attention_mask[safe], 0)
            mask[:, -1] = np.maximum(mask[:, -1], 1)  # rows not taken: one valid token
            first = self._admit(input_ids[safe], mask, slots, take, req_ids[safe]).cpu().numpy()
            cap_take = caps[safe]
            first_eos = (first == eos) & has_eos
            fin0 = take & (first_eos | (cap_take <= 1))
            write0 = take & ~first_eos
            out[safe[write0], 0] = first[write0]
            out_len[safe[fin0]] = np.where(first_eos, 0, np.minimum(cap_take, 1))[fin0]
            slot_req[slots[take]] = np.where(fin0, -1, safe)[take]
            gen_count[slots[take]] = 1
            next_req += int(take.sum())

        def speculative_step(active, safe, g0):
            """Verify G prompt-lookup drafts a slot over its [prompt | tokens] history and commit 1 to G + 1
            tokens, cut before an EOS among them. Returns the slots' new token counts."""
            hist = torch.as_tensor(np.concatenate([input_ids[safe], out[safe]], axis=1))
            draft = prompt_lookup(hist, torch.as_tensor(P + g0 - 1), torch.as_tensor(P - attention_mask[safe].sum(1)),
                                  G, 2)
            cap = caps[safe]
            emit, m = self._verify(active, draft, cap - g0, req_ids[safe], g0)
            emit, m = emit.cpu().numpy(), m.cpu().numpy()
            eos_at = (emit == eos) & (np.arange(G + 1)[None, :] < m[:, None]) & has_eos
            eos_any = eos_at.any(axis=1)
            m = np.where(eos_any, eos_at.argmax(axis=1), m)
            finished = active & (eos_any | (g0 + m >= cap))
            for b in np.flatnonzero(active):
                out[safe[b], g0[b]:g0[b] + m[b]] = emit[b, :m[b]]
            out_len[safe[finished]] = (g0 + m)[finished]
            slot_req[finished] = -1
            return g0 + m

        while (slot_req >= 0).any() or next_req < N:
            remaining = N - next_req
            if remaining > 0 and (slot_req < 0).sum() >= min(max(B // 2, 1), remaining):
                admit()
            active = slot_req >= 0
            if not active.any():
                continue  # every admitted request ended on its first token
            safe = np.clip(slot_req, 0, N - 1)
            g0 = gen_count.copy()
            if G:
                gen_count = speculative_step(active, safe, g0)
                continue
            nxt_t = self._step(req_t[safe], torch.as_tensor(g0))
            nxt = nxt_t.cpu().numpy()
            eos_hit = (nxt == eos) & active & has_eos
            write = active & ~eos_hit
            out[safe[write], g0[write]] = nxt[write]
            g1 = g0 + active
            finished = active & (eos_hit | (g1 >= caps[safe]))
            out_len[safe[finished]] = np.where(eos_hit, g0, g1)[finished]
            act = torch.as_tensor(active, device=self.device)
            self._advance(act, torch.where(act, nxt_t.long(), self.state["tok"]))
            slot_req[finished] = -1
            gen_count = g1
        return out, out_len
