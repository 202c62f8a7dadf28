"""Token-level continuous batching: per-sequence KV slots with mid-decode
admission (counterpart of ``vggt_qwen3_tpu/inference/slots.py``).

- One persistent KV cache of ``num_slots`` rows × a row length (``max_len``
  plus the speculative block's scratch, rounded up to 32), int8 or bf16,
  updated in place. Each slot holds one in-flight sequence, left-aligned in
  its row; slots live at different depths at once.
- **Admission** prefills a prompt (spliced, left-padded to the prompt
  bucket) into a free slot's row: same-bucket arrivals in power-of-two
  batches up to ``admit_batch_max`` (one flash prefill over A rows), a
  request on a registered prefix alone (a chunked prefill of its suffix at
  ``cache_offset = P`` over a copy of the stashed prefix row).
- **Decode** advances every slot ``decode_chunk`` tokens, each step one
  forward with per-row cache offsets ([B] ``cache_offset``). Finished and
  empty slots decode junk into masked columns that the next admission
  overwrites.
- **Speculative** (``speculative=True``): each chunk runs ``spec_chunk``
  prompt-lookup verify blocks, each advancing every slot 1..k+1 tokens;
  ``submit_embeds(..., lookup_ids=...)`` seeds a slot's draft memory with
  its text prompt ids. A guard falls back to plain chunks when the rolling
  gain over ``spec_guard_window`` blocks is under ``spec_min_gain``.
- **Frontier kernels**: while every key-mask row is one contiguous run, the
  decode steps and verify blocks declare ``decode_frontier`` and run the
  decode-attention and block-verify kernels. The first prefixed admission
  leaves a holed row (prefix ones, the suffix's left-pad zeros, then the
  suffix); from then on (``_frontier_ok`` False, for good) every step takes
  the plain attention over the cache.
- **Delivery one chunk late**: each chunk ends with a packed ``[B, N+2]``
  snapshot (done | n_gen | out), copied to pinned host memory without
  blocking, with an event recorded after the copy. The host reads it after
  the next chunk has been launched, so the copy's wait overlaps that
  chunk's device work. Finished rows freeze on the device, so a lagged done
  flag is valid for a slot's occupant; ``_slot_admit_boundary`` keeps a
  snapshot older than an admission from delivering the slot's new occupant.

Greedy + repetition-penalty semantics are ``engine.generate``'s (the same
processors and seen-buffer rules, the constraint FSM); the JAX module's
jitted programs, ``lax.scan`` and buffer donation become plain loops over
tensors updated in place. ``penalize_prompt`` is refused, as in JAX.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import MISSING, dataclass, field, fields
from queue import Empty, Queue
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import Qwen3Config
from ..models import qwen3
from .engine import GenerationConfig, _processors, advance_fsm, constrained_greedy
from .speculative import draft_lookup

# ---------------------------------------------------------------------------
# Device-side state
# ---------------------------------------------------------------------------


def init_slot_state(cfg: Qwen3Config, gen_cfg: GenerationConfig, num_slots: int, max_len: int,
                    device="cuda") -> Dict[str, object]:
    """All slot bookkeeping, as tensors on ``device`` (updated in place);
    raises for CUDA without a card."""
    B, N = num_slots, gen_cfg.max_new_tokens
    device = resolve_device(device)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "cache": qwen3.init_cache(cfg, B, max_len, dtype=gen_cfg.kv_dtype or cfg.dtype, device=device),
        "kv_mask": zeros(B, max_len),  # per-row key frontier
        "write_off": zeros(B),         # next cache column
        "rot_pos": zeros(B),           # next rotary position
        "next_logits": zeros(B, cfg.vocab_size, dtype=torch.float32),
        "seen_ids": zeros(B, N),
        "seen_len": zeros(B),
        "active": zeros(B, dtype=torch.bool),
        "done": torch.ones((B,), dtype=torch.bool, device=device),
        "out": zeros(B, N),
        "n_gen": zeros(B),
        # per-slot budget (≤ N): slots free at different chunk boundaries
        "budget": torch.full((B,), N, dtype=torch.int32, device=device),
        # prompt-lookup draft memory: the TEXT prompt ids, then the generated
        # tokens; [start, len) is the matchable window
        "ids_buf": zeros(B, max_len),
        "ids_start": zeros(B),
        "ids_len": zeros(B),
        # constraint FSM state (engine-wide table; 0 at admission)
        "fsm": zeros(B),
    }


@torch.inference_mode()
def _prefix_prefill(params, cfg: Qwen3Config, inputs_embeds: torch.Tensor, kv_dtype: Optional[str],
                    row_len: int):
    """Prefill a DENSE shared prefix [1, P, H] once into a fresh one-row cache
    of ``row_len`` slots → (that cache, its [1, row_len] key mask). Prefix
    K/V depend only on the prefix (causal), so the stashed row is what a
    prefill of prefix + suffix writes there."""
    P = inputs_embeds.shape[1]
    dev = inputs_embeds.device
    cache = qwen3.init_cache(cfg, 1, row_len, dtype=kv_dtype, device=dev)
    mask = torch.zeros((1, row_len), dtype=torch.int32, device=dev)
    mask[:, :P] = 1
    qwen3.forward_hidden(params, cfg, inputs_embeds, attention_mask=mask,
                         positions=torch.arange(P, device=dev)[None], cache=cache, cache_offset=0,
                         prefill_padding="right")
    return cache, mask


def _arm_lookup(state, slots: torch.Tensor, lookup_ids: torch.Tensor) -> None:
    """Seed the draft memory of ``slots`` [A] with text prompt ids [A, L]
    (LEFT-padded with zeros): the matchable window starts at a row's FIRST
    nonzero id (all zeros: empty, drafting waits for generated history)."""
    A, L = lookup_ids.shape
    ids32 = lookup_ids.to(torch.int32)
    state["ids_buf"][slots] = 0
    state["ids_buf"][slots, :L] = ids32
    nz = ids32 != 0
    state["ids_start"][slots] = torch.where(nz.any(1), torch.argmax(nz.int(), 1).int(), L).int()
    state["ids_len"][slots] = L


def _arm_slots(state, slots: torch.Tensor, row_mask: torch.Tensor, write_off, rot_pos: torch.Tensor,
               logits: torch.Tensor, budgets: torch.Tensor, lookup_ids: torch.Tensor) -> None:
    """The bookkeeping of an admission into ``slots`` [A]: key mask rows,
    offsets, the next logits, budgets, cleared output and draft memory."""
    state["kv_mask"][slots] = row_mask
    state["write_off"][slots] = write_off
    state["rot_pos"][slots] = rot_pos.int()
    state["next_logits"][slots] = logits
    for name in ("seen_ids", "seen_len", "out", "n_gen", "fsm"):
        state[name][slots] = 0
    state["active"][slots] = True
    state["done"][slots] = False
    state["budget"][slots] = budgets.int()
    _arm_lookup(state, slots, lookup_ids)


@torch.inference_mode()
def _admit_prefixed(params, state, cfg: Qwen3Config, slot: int, inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, budget: int, prefix_cache, prefix_mask: torch.Tensor,
                    prefix_len: int, lookup_ids: Optional[torch.Tensor] = None) -> None:
    """Admit a left-padded suffix [1, S, H] on a stashed prefix: the slot's
    row starts as a copy of the prefix row, and only the suffix is
    prefilled into it (a chunked prefill at ``cache_offset = prefix_len``,
    through a view of the row) — admission costs the suffix, not the whole
    prompt."""
    S = inputs_embeds.shape[1]
    dev = inputs_embeds.device
    am = attention_mask.to(device=dev, dtype=torch.int32)
    row_mask = prefix_mask.clone()
    row_mask[:, prefix_len:prefix_len + S] = am
    positions = prefix_len + torch.clamp_min(torch.cumsum(am, -1) - 1, 0)
    for name, buf in state["cache"].items():
        buf[:, slot] = prefix_cache[name][:, 0]
    row_cache = {name: buf[:, slot:slot + 1] for name, buf in state["cache"].items()}
    logits, _ = qwen3.forward(params, cfg, inputs_embeds=inputs_embeds, attention_mask=row_mask,
                              positions=positions, cache=row_cache, cache_offset=prefix_len, last_logit_only=True)
    slots = torch.tensor([slot], device=dev)
    if lookup_ids is None:
        lookup_ids = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    _arm_slots(state, slots, row_mask, prefix_len + S, prefix_len + am.sum(-1), logits[:, -1],
               torch.tensor([budget], device=dev), lookup_ids)


@torch.inference_mode()
def _admit_batch(params, state, cfg: Qwen3Config, slots: torch.Tensor, inputs_embeds: torch.Tensor,
                 attention_mask: torch.Tensor, budgets: torch.Tensor, lookup_ids: torch.Tensor) -> None:
    """Admit A same-bucket prompts in one prefill: ``slots`` [A] (distinct),
    ``inputs_embeds`` [A, S, H], ``attention_mask`` [A, S] (left-padded),
    ``budgets`` [A], ``lookup_ids`` [A, L]. The prefill writes a fresh
    S-slot cache, copied into columns ``[0, S)`` of the slots' rows; the
    rest of each row is masked until decode writes it. Prefill attention is
    per row, so batching the rows changes no math."""
    A, S = attention_mask.shape
    dev = inputs_embeds.device
    T = state["kv_mask"].shape[1]
    am = attention_mask.to(device=dev, dtype=torch.int32)
    kv_dtype = "int8" if "ks" in state["cache"] else state["cache"]["k"].dtype
    row_cache = qwen3.init_cache(cfg, A, S, dtype=kv_dtype, device=dev)
    positions = torch.clamp_min(torch.cumsum(am, -1) - 1, 0)
    logits, row_cache = qwen3.forward(params, cfg, inputs_embeds=inputs_embeds, attention_mask=am,
                                      positions=positions, cache=row_cache, cache_offset=0,
                                      prefill_padding="left", last_logit_only=True)
    for name, buf in state["cache"].items():
        buf[:, slots, :, :S] = row_cache[name]
    row_mask = torch.zeros((A, T), dtype=torch.int32, device=dev)
    row_mask[:, :S] = am
    _arm_slots(state, slots, row_mask, S, am.sum(-1), logits[:, -1], budgets, lookup_ids)


def _admit(params, state, cfg: Qwen3Config, slot: int, inputs_embeds: torch.Tensor,
           attention_mask: torch.Tensor, budget: int, lookup_ids: Optional[torch.Tensor] = None) -> None:
    """Prefill one prompt ([1, S, H], left-padded mask [1, S]) into row
    ``slot`` and arm the slot; other rows are untouched."""
    dev = inputs_embeds.device
    if lookup_ids is None:
        lookup_ids = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    _admit_batch(params, state, cfg, torch.tensor([slot], device=dev), inputs_embeds, attention_mask,
                 torch.tensor([budget], device=dev), lookup_ids)


def _snapshot(state) -> torch.Tensor:
    """The packed [B, N+2] int32 snapshot: done | n_gen | out."""
    return torch.cat([state["done"].int()[:, None], state["n_gen"][:, None], state["out"]], dim=1)


@torch.inference_mode()
def _decode_chunk(params, state, cfg: Qwen3Config, gen_cfg: GenerationConfig, chunk: int,
                  constraint: Optional[torch.Tensor] = None, frontier: bool = False) -> torch.Tensor:
    """Advance every slot ``chunk`` tokens; returns the packed snapshot.

    ``frontier``: every key-mask row is one contiguous run, so the steps
    declare ``decode_frontier`` (the decode-attention kernel)."""
    B = state["active"].shape[0]
    N = gen_cfg.max_new_tokens
    T = state["kv_mask"].shape[1]
    rows = torch.arange(B, device=state["active"].device)
    for _ in range(chunk):
        logits = _processors(state["next_logits"], state["seen_ids"], state["seen_len"], gen_cfg)
        tok = constrained_greedy(state["next_logits"], logits, state["fsm"], constraint)
        stopped = state["done"] | ~state["active"]
        state["fsm"] = advance_fsm(constraint, state["fsm"], tok, ~stopped)
        out_tok = torch.where(stopped, torch.full_like(tok, gen_cfg.pad_token_id), tok)
        done = state["done"]
        if gen_cfg.eos_token_id is not None:
            done = done | (tok == gen_cfg.eos_token_id)
        # budget exhaustion also finishes the slot (per-slot budget ≤ N)
        n_gen = torch.where(stopped, state["n_gen"], state["n_gen"] + 1)
        state["done"] = done | (n_gen >= state["budget"].clamp_max(N))
        write_idx = state["n_gen"].clamp(0, N - 1).long()
        state["out"][rows, write_idx] = torch.where(stopped, state["out"][rows, write_idx], out_tok)
        state["n_gen"] = n_gen
        state["seen_ids"][rows, state["seen_len"].clamp(0, N - 1).long()] = out_tok
        state["seen_len"] = torch.where(stopped, state["seen_len"], state["seen_len"] + 1)

        # every slot advances (finished slots write junk into columns the
        # next admission overwrites)
        off = state["write_off"].clamp(0, T - 1)
        state["kv_mask"][rows, off.long()] = 1
        logits_new, _ = qwen3.forward(
            params, cfg, inputs_embeds=qwen3.embed_tokens(params, out_tok[:, None]),
            attention_mask=state["kv_mask"], positions=state["rot_pos"][:, None], cache=state["cache"],
            cache_offset=off, decode_frontier=frontier,
        )
        state["write_off"] = off + 1
        state["rot_pos"] = state["rot_pos"] + 1
        state["next_logits"] = logits_new[:, 0]
    return _snapshot(state)


@torch.inference_mode()
def _spec_chunk(params, state, cfg: Qwen3Config, gen_cfg: GenerationConfig, k: int, ngram: int,
                constraint: Optional[torch.Tensor] = None, frontier: bool = False,
                blocks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``blocks`` speculative verify blocks, each advancing every active slot
    1..k+1 tokens (prompt-lookup drafts; ``_decode_chunk``'s token
    semantics). Returns (the packed snapshot, accepted [blocks, B]: the
    tokens each block emitted a slot, tok0 included; 0 = idle)."""
    B = state["active"].shape[0]
    N = gen_cfg.max_new_tokens
    T = state["kv_mask"].shape[1]
    dev = state["active"].device
    rows = torch.arange(B, device=dev)
    jpos = torch.arange(k + 1, device=dev)
    tpos = torch.arange(T, device=dev)[None, None, :]
    eos = gen_cfg.eos_token_id
    accepted = []

    def record(emit, tok, out_at):
        """Where ``emit``: append ``tok`` to the seen ids, the draft memory
        and the output (column ``out_at``), and advance the FSM."""
        for buf, at in (("seen_ids", state["seen_len"]), ("ids_buf", state["ids_len"]), ("out", out_at)):
            idx = at.clamp(0, state[buf].shape[1] - 1).long()
            state[buf][rows, idx] = torch.where(emit, tok, state[buf][rows, idx])
        state["seen_len"] = state["seen_len"] + emit.int()
        state["ids_len"] = state["ids_len"] + emit.int()
        state["fsm"] = advance_fsm(constraint, state["fsm"], tok, emit)

    for _ in range(blocks):
        n_gen = state["n_gen"]
        budget_eff = state["budget"].clamp_max(N)
        stopped = state["done"] | ~state["active"]
        raw0 = state["next_logits"]
        tok0 = constrained_greedy(raw0, _processors(raw0, state["seen_ids"], state["seen_len"], gen_cfg),
                                  state["fsm"], constraint)
        drafts = draft_lookup(state["ids_buf"], state["ids_start"], state["ids_len"], tok0, k, ngram)

        # one forward over [tok0, drafts] at each slot's own depth
        off = state["write_off"].clamp(0, T - (k + 1))
        inblock = (tpos >= off[:, None, None]) & ((tpos - off[:, None, None]) <= jpos[None, :, None])
        amask = (state["kv_mask"].bool()[:, None, :] | inblock).int()  # [B, k+1, T]
        logits, _ = qwen3.forward(
            params, cfg, input_ids=torch.cat([tok0[:, None], drafts], dim=1), attention_mask=amask,
            positions=state["rot_pos"][:, None] + jpos[None, :], cache=state["cache"], cache_offset=off,
            decode_frontier=frontier,
        )
        logits = logits.float()

        # acceptance: emit tok0, then each draft while it is the model's token
        can0 = ~stopped & (n_gen < budget_eff)
        record(can0, tok0, n_gen)
        a = can0.int()
        hit_eos = can0 & (tok0 == eos) if eos is not None else torch.zeros_like(can0)
        alive = can0 & ~hit_eos & (n_gen + a < budget_eff)
        for j in range(1, k + 1):
            lprev = logits[:, j - 1]
            true_j = constrained_greedy(lprev, _processors(lprev, state["seen_ids"], state["seen_len"], gen_cfg),
                                        state["fsm"], constraint)
            accept = alive & (drafts[:, j - 1] == true_j)
            record(accept, true_j, n_gen + a)
            a = a + accept.int()
            alive = accept
            if eos is not None:
                e = accept & (true_j == eos)
                hit_eos = hit_eos | e
                alive = accept & ~e
            alive = alive & (n_gen + a < budget_eff)

        gathered = logits[rows, (a - 1).clamp(0, k).long()]
        state["next_logits"] = torch.where((a > 0)[:, None], gathered, state["next_logits"])
        # only the ACCEPTED block columns become valid keys; rejected columns
        # stay masked and the next block overwrites them
        cols = off[:, None] + jpos[None, :]
        accept_cols = (jpos[None, :] < a[:, None]) & (cols < T)
        state["kv_mask"].scatter_reduce_(1, cols.clamp(0, T - 1).long(), accept_cols.int(), reduce="amax")
        state["n_gen"] = n_gen + a
        state["done"] = state["done"] | hit_eos | (state["n_gen"] >= budget_eff)
        state["write_off"] = off + a
        state["rot_pos"] = state["rot_pos"] + a
        accepted.append(a)
    return _snapshot(state), torch.stack(accepted)


class _Lagged:
    """A device tensor on its way to the host: copied into pinned memory
    without blocking, an event recorded after the copy (on the card); a
    CPU tensor is kept as it is. :meth:`numpy` waits for the copy only."""

    def __init__(self, t: Optional[torch.Tensor]):
        self.event = None
        if t is None or not t.is_cuda:
            self.host = t
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self) -> Optional[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return None if self.host is None else self.host.numpy()


# ---------------------------------------------------------------------------
# Host scheduler
# ---------------------------------------------------------------------------


@dataclass
class _Pending:
    inputs_embeds: object         # [1, S, H], numpy or a tensor
    attention_mask: object        # [1, S]
    future: Future
    submitted_at: float = 0.0
    max_new_tokens: Optional[int] = None  # per-request budget (≤ engine max)
    prefix_id: Optional[int] = None       # registered shared-prefix handle
    lookup_ids: Optional[object] = None   # [1, L] TEXT ids seeding drafts


@dataclass
class SlotStats:
    requests: int = 0
    chunks: int = 0
    admitted_mid_decode: int = 0
    tokens: int = 0
    admit_dispatches: int = 0     # admission prefills run (≤ requests with batched admission)
    admission_wait_s: float = 0.0  # Σ (admit time − submit time) over requests
    admission_log: List[Tuple[int, int]] = field(default_factory=list)  # (chunk_idx, slot)
    spec_blocks: int = 0          # speculative verify blocks run with an active slot
    spec_accepted: int = 0        # tokens emitted by those blocks (tok0 included)
    spec_disabled_at: Optional[int] = None  # chunk index at which the guard tripped
    # KV-cache occupancy integrated over chunks: per observed chunk, used =
    # live tokens (valid prompt + generated) over occupied slots; reserved =
    # num_slots × row length
    kv_used_token_chunks: int = 0
    kv_reserved_token_chunks: int = 0

    @property
    def kv_utilization(self) -> float:
        return self.kv_used_token_chunks / max(self.kv_reserved_token_chunks, 1)

    def reset(self) -> None:
        """Every field back to its default, so that a pass after a warm-up
        counts itself alone."""
        for f in fields(self):
            setattr(self, f.name, f.default_factory() if f.default_factory is not MISSING else f.default)


class SlotEngine:
    """Host scheduler over the admit / decode-chunk functions.

    ``submit_embeds`` enqueues a prepared (spliced, left-padded to the
    prompt bucket) prompt; the caller gets a Future resolving to
    ``(tokens [n_gen] numpy, n_gen)``. ``run_until_idle`` drives the loop
    inline (tests, batch jobs); ``start``/``stop`` run it on a thread
    (serving). The device is that of the params.
    """

    def __init__(self, params, cfg: Qwen3Config, gen_cfg: GenerationConfig, *,
                 num_slots: int, max_len: int, decode_chunk: int = 4,
                 speculative: bool = False, draft_k: int = 6,
                 ngram: int = 3, spec_chunk: int = 4, constraint=None,
                 spec_min_gain: float = 1.35,
                 spec_guard_window: int = 8,
                 admit_batch_max: int = 8,
                 track_metrics: bool = False) -> None:
        self.params = params
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        if gen_cfg.penalize_prompt:
            raise ValueError(
                "SlotEngine decodes from pre-spliced embeds; prompt ids are not tracked, so "
                "penalize_prompt=True cannot reproduce engine.generate here (the inputs_embeds "
                "path starts the penalty set empty — use penalize_prompt=False)")
        self.device = params["final_norm"].device  # a tensor in dense and W8 trees
        self.num_slots = num_slots
        self.max_len = max_len
        self.decode_chunk = decode_chunk
        self.speculative = self._speculative = speculative
        self.draft_k = draft_k
        self.ngram = ngram
        self.spec_chunk = spec_chunk  # verify blocks a chunk
        # the guard: when the rolling mean gain (tokens a verify block emits
        # per active slot) over ``spec_guard_window`` blocks falls under
        # ``spec_min_gain``, plain chunks take over (same tokens, another
        # schedule); 0 disables it
        self.spec_min_gain = spec_min_gain
        self.spec_guard_window = spec_guard_window
        # largest batched admission (power-of-two groups; 1 admits one by one)
        self.admit_batch_max = max(1, admit_batch_max)
        # opt-in per-request latency metrics: future → {"submit", "admit",
        # "first_tok", "done", "n"} wall times; first_tok at chunk
        # granularity from the lagged snapshots. Pop with req_meta.pop(fut).
        self.track_metrics = track_metrics
        self.req_meta: Dict[object, Dict[str, float]] = {}
        self._spec_gain_window: List[float] = []
        self.constraint = None if constraint is None else torch.as_tensor(constraint).to(self.device)
        # a verify block writes k+1 columns from a slot's frontier: scratch
        # columns past the budget; the row length rounds UP to 32
        raw_len = max_len + (draft_k + 1 if speculative else 0)
        self._row_len = -(-raw_len // 32) * 32
        self.state = init_slot_state(cfg, gen_cfg, num_slots, self._row_len, self.device)
        self.prefixes: Dict[int, Tuple[Dict[str, torch.Tensor], torch.Tensor, int]] = {}
        self._next_prefix_id = 0
        self.queue: "Queue[_Pending]" = Queue()
        self.slot_futures: List[Optional[Future]] = [None] * num_slots
        self.stats = SlotStats()
        self._chunk_idx = 0
        self._pending_snap = None  # the one-deep snapshot pipeline (step_once)
        # first chunk that can report on each slot's CURRENT occupant
        self._slot_admit_boundary = [0] * num_slots
        # live prompt tokens per occupant (valid prompt + prefix), for the
        # KV-occupancy measurement
        self._slot_prompt_tokens = [0] * num_slots
        # every key-mask row is one contiguous run until a prefixed admission:
        # until then the steps run the frontier kernels; False for good after
        self._frontier_ok = True
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        """``x`` (a tensor, numpy or a list) on the engine's device."""
        t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    # -- submission ---------------------------------------------------------

    def register_prefix(self, inputs_embeds) -> int:
        """Prefill a DENSE shared prefix ([1, P, H] embeds, no padding) once
        and stash its KV row; returns a handle for ``submit_embeds``'s
        ``prefix_id`` (a system hint shared by every request: admission then
        prefills only the request's suffix)."""
        P = inputs_embeds.shape[1]
        if P >= self.max_len - self.gen_cfg.max_new_tokens:
            raise ValueError(f"prefix length {P} leaves no room in the {self.max_len}-token slot row")
        with self._lock:
            cache, mask = _prefix_prefill(self.params, self.cfg, self._tensor(inputs_embeds),
                                          self.gen_cfg.kv_dtype or self.cfg.dtype, self._row_len)
            pid = self._next_prefix_id
            self._next_prefix_id += 1
            self.prefixes[pid] = (cache, mask, P)
        return pid

    def submit_embeds(self, inputs_embeds, attention_mask, max_new_tokens: Optional[int] = None,
                      prefix_id: Optional[int] = None, lookup_ids=None) -> Future:
        """Enqueue a prompt: ``inputs_embeds`` [1, S, H] and its left-padded
        ``attention_mask`` [1, S] (numpy or tensors). ``lookup_ids``: optional
        [1, L] TEXT token ids, LEFT-padded with zeros, seeding the
        speculative draft memory (ignored otherwise; never changes which
        tokens come out)."""
        fut: Future = Future()
        if max_new_tokens is not None and not (0 < max_new_tokens <= self.gen_cfg.max_new_tokens):
            fut.set_exception(ValueError(
                f"max_new_tokens {max_new_tokens} outside (0, {self.gen_cfg.max_new_tokens}] engine budget"))
            return fut
        if prefix_id is not None and prefix_id not in self.prefixes:
            fut.set_exception(ValueError(f"unknown prefix_id {prefix_id}"))
            return fut
        room = self._row_len - self.gen_cfg.max_new_tokens
        if lookup_ids is not None and (lookup_ids.ndim != 2 or lookup_ids.shape[0] != 1
                                       or lookup_ids.shape[1] > room):
            fut.set_exception(ValueError(
                f"lookup_ids must be [1, L] with L ≤ {room}; got {tuple(lookup_ids.shape)}"))
            return fut
        self.queue.put(_Pending(inputs_embeds, attention_mask, fut, time.time(), max_new_tokens, prefix_id,
                                lookup_ids))
        return fut

    # -- scheduler core -----------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, f in enumerate(self.slot_futures) if f is None]

    def _any_active(self) -> bool:
        return any(f is not None for f in self.slot_futures)

    def _lookup_of(self, req: _Pending) -> torch.Tensor:
        if req.lookup_ids is not None:
            return self._tensor(req.lookup_ids, torch.int32)
        return torch.zeros(tuple(req.attention_mask.shape), dtype=torch.int32, device=self.device)

    def _budget(self, req: _Pending) -> int:
        return req.max_new_tokens or self.gen_cfg.max_new_tokens

    def _admit_pending(self) -> None:
        was_decoding = self._any_active()
        free = self._free_slots()
        paired: List[Tuple[int, _Pending]] = []
        while len(paired) < len(free):
            try:
                req = self.queue.get_nowait()
            except Empty:
                break
            S = req.inputs_embeds.shape[1]
            P = 0 if req.prefix_id is None else self.prefixes[req.prefix_id][2]
            if P + S > self.max_len - self.gen_cfg.max_new_tokens:
                req.future.set_exception(ValueError(
                    f"prompt length {P}+{S} exceeds slot budget {self.max_len - self.gen_cfg.max_new_tokens}"))
                continue  # a rejected request takes no slot
            paired.append((free[len(paired)], req))
        if not paired:
            return

        now = time.time()
        # same-shape plain admissions in power-of-two groups, one prefill
        # each; prefixed admissions one by one (each copies its prefix row).
        # Group key: (prompt bucket, lookup bucket)
        groups: Dict[Tuple[int, int], List[Tuple[int, _Pending]]] = {}
        singles: List[Tuple[int, _Pending]] = []
        for slot, req in paired:
            if req.prefix_id is not None:
                singles.append((slot, req))
                continue
            lkL = (req.lookup_ids if req.lookup_ids is not None else req.attention_mask).shape[1]
            groups.setdefault((req.inputs_embeds.shape[1], lkL), []).append((slot, req))

        for members in groups.values():
            i = 0
            while i < len(members):
                rem = len(members) - i
                A = 1
                while A * 2 <= rem and A * 2 <= self.admit_batch_max:
                    A *= 2
                chunk = members[i:i + A]
                i += A
                if A == 1:
                    slot, req = chunk[0]
                    _admit(self.params, self.state, self.cfg, slot, self._tensor(req.inputs_embeds),
                           self._tensor(req.attention_mask, torch.int32), self._budget(req), self._lookup_of(req))
                else:
                    _admit_batch(
                        self.params, self.state, self.cfg, self._tensor([s for s, _ in chunk]),
                        torch.cat([self._tensor(r.inputs_embeds) for _, r in chunk]),
                        torch.cat([self._tensor(r.attention_mask, torch.int32) for _, r in chunk]),
                        self._tensor([self._budget(r) for _, r in chunk], torch.int32),
                        torch.cat([self._lookup_of(r) for _, r in chunk]),
                    )
                self.stats.admit_dispatches += 1
                self._post_admit(chunk, was_decoding, now)

        for slot, req in singles:
            cache, mask, P = self.prefixes[req.prefix_id]
            self._frontier_ok = False  # a holed row lives in the cache now
            _admit_prefixed(self.params, self.state, self.cfg, slot, self._tensor(req.inputs_embeds),
                            self._tensor(req.attention_mask, torch.int32), self._budget(req), cache, mask, P,
                            self._lookup_of(req))
            self.stats.admit_dispatches += 1
            self._post_admit([(slot, req)], was_decoding, now)

    def _post_admit(self, chunk: List[Tuple[int, _Pending]], was_decoding: bool, now: float) -> None:
        for slot, req in chunk:
            P = 0 if req.prefix_id is None else self.prefixes[req.prefix_id][2]
            self.slot_futures[slot] = req.future
            self._slot_admit_boundary[slot] = self._chunk_idx + 1
            self._slot_prompt_tokens[slot] = P + int(torch.as_tensor(req.attention_mask).sum())
            self.stats.requests += 1
            if req.submitted_at:
                self.stats.admission_wait_s += now - req.submitted_at
            if self.track_metrics:
                self.req_meta[req.future] = {"submit": req.submitted_at or now, "admit": now}
            if len(self.stats.admission_log) < 4096:  # diagnostics: capped for a long-running server
                self.stats.admission_log.append((self._chunk_idx, slot))
            if was_decoding:
                self.stats.admitted_mid_decode += 1

    def _deliver_from(self, snap_idx: int, snap: np.ndarray) -> None:
        """Deliver finished requests from the chunk-``snap_idx`` snapshot
        (packed [B, N+2]: done | n_gen | out), one chunk old. A slot admitted
        after that chunk is skipped (``_slot_admit_boundary``): the snapshot
        carries its previous occupant's flags."""
        done, n_gen, out = snap[:, 0] > 0, snap[:, 1], snap[:, 2:]
        # KV occupancy at this chunk: prompt + generated tokens of every
        # occupied slot, against the reserved rows
        used = sum(self._slot_prompt_tokens[i] + int(n_gen[i]) for i, f in enumerate(self.slot_futures)
                   if f is not None and self._slot_admit_boundary[i] <= snap_idx)
        self.stats.kv_used_token_chunks += used
        self.stats.kv_reserved_token_chunks += self.num_slots * self._row_len
        if self.track_metrics:
            now = time.time()
            for i, fut in enumerate(self.slot_futures):
                if fut is None or self._slot_admit_boundary[i] > snap_idx or int(n_gen[i]) <= 0:
                    continue
                meta = self.req_meta.get(fut)
                if meta is not None and "first_tok" not in meta:
                    meta["first_tok"] = now
        freed = []
        for i, fut in enumerate(self.slot_futures):
            if fut is None or not done[i] or self._slot_admit_boundary[i] > snap_idx:
                continue
            n = int(n_gen[i])
            # n and stats.tokens INCLUDE a trailing EOS (engine.generate's
            # lengths); decode(skip_special_tokens) hides it
            self.stats.tokens += n
            if self.track_metrics:
                meta = self.req_meta.get(fut)
                if meta is not None:
                    meta.setdefault("first_tok", time.time())
                    meta["done"] = time.time()
                    meta["n"] = n
            self.slot_futures[i] = None
            freed.append(i)
            fut.set_result((out[i, :n].copy(), n))
        if freed:
            self.state["active"][torch.tensor(freed, device=self.device)] = False

    def step_once(self) -> bool:
        """One scheduler iteration. Returns True if any work remains."""
        with self._lock:
            self._admit_pending()
            if self._any_active():
                accepted = None
                if self.speculative:
                    snap, accepted = _spec_chunk(self.params, self.state, self.cfg, self.gen_cfg, self.draft_k,
                                                 self.ngram, self.constraint, frontier=self._frontier_ok,
                                                 blocks=self.spec_chunk)
                else:
                    snap = _decode_chunk(self.params, self.state, self.cfg, self.gen_cfg, self.decode_chunk,
                                         self.constraint, frontier=self._frontier_ok)
                self._chunk_idx += 1
                self.stats.chunks += 1
                # pipeline: read the PREVIOUS chunk's snapshot while this one runs
                prev, self._pending_snap = self._pending_snap, (self._chunk_idx, _Lagged(snap),
                                                                _Lagged(accepted))
                if prev is not None:
                    self._deliver_from(prev[0], prev[1].numpy())
                    self._update_spec_guard(prev[2].numpy())
                return True
            if self._pending_snap is not None:  # drain the trailing snapshot
                prev, self._pending_snap = self._pending_snap, None
                self._deliver_from(prev[0], prev[1].numpy())
                self._update_spec_guard(prev[2].numpy())
                return True
            return not self.queue.empty()

    def _update_spec_guard(self, accepted: Optional[np.ndarray]) -> None:
        """Feed one lagged [blocks, B] acceptance array into the rolling
        guard; turn speculative chunks off when the mean gain per active
        slot under-runs ``spec_min_gain`` over the window."""
        if accepted is None or not self.spec_min_gain:
            return
        w = self._spec_gain_window
        for a in np.atleast_2d(accepted):
            active = a > 0
            if not active.any():
                continue
            self.stats.spec_blocks += 1
            self.stats.spec_accepted += int(a.sum())
            w.append(float(a[active].mean()))
        if len(w) > self.spec_guard_window:
            del w[: len(w) - self.spec_guard_window]
        if self.speculative and len(w) == self.spec_guard_window and sum(w) / len(w) < self.spec_min_gain:
            self.speculative = False
            self.stats.spec_disabled_at = self._chunk_idx
            print(f"slots: speculative decoding turned off at chunk {self._chunk_idx} (rolling gain "
                  f"{sum(w) / len(w):.2f} tokens a block < {self.spec_min_gain}); plain chunks from here",
                  flush=True)

    def reset_speculation(self) -> None:
        """Speculative chunks as the engine was built with, and the guard's
        window empty: a guard that tripped in a warm-up pass does not carry
        into the next pass. Only between passes (the engine idle)."""
        if self._any_active() or self._pending_snap is not None or not self.queue.empty():
            raise RuntimeError("reset_speculation needs an idle engine (no request queued, admitted or undelivered)")
        self.speculative = self._speculative
        self._spec_gain_window.clear()

    def run_until_idle(self) -> None:
        while self.step_once():
            pass

    # -- threaded serving ---------------------------------------------------

    def start(self) -> None:
        def loop():
            while not self._stop.is_set():
                if not self.step_once() and self.queue.empty():
                    time.sleep(0.002)  # idle; requests arrive through submit_embeds

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
