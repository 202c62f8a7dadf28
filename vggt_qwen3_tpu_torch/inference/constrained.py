"""Constrained action-JSON decoding (counterpart of
``vggt_qwen3_tpu/inference/constrained.py``, numpy only; the port keeps its
own copy).

1. A character-level DFA for the exact RoomPlan action schema
   ``{"action": "<str>", "scene": "<str>", "center": [n, n, n],
   "normal": [n, n, n], "extent": [n, n, n]}`` (json.dumps separators, free
   string/number values of bounded length, then EOS).
2. The DFA is compiled against the tokenizer once: every vocab token's
   surface string is walked through the DFA from every state, giving a dense
   transition table ``[num_states + 1, vocab] int16`` (−1 = token forbidden
   in that state; the last row is a terminal sink). A multi-character token
   is allowed iff its whole string is a valid continuation.
3. At each decode step the engine masks the logits with
   ``table[state] >= 0`` and advances ``state = table[state, tok]``
   (``engine.constrained_greedy``).

Off by default; ``--constrained_json`` opts in (``inference/arkit.py``).
The tables are bit-identical to the JAX module's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Character-level DFA for the action-JSON schema
# ---------------------------------------------------------------------------

_DIGITS = "0123456789"
# string-value alphabet: printable chars except the closing quote and
# backslash (the prep pipelines never emit escapes)
_STR_CHARS = "".join(
    chr(c) for c in range(32, 127) if chr(c) not in ('"', "\\")
)


class _DFA:
    """A DFA under construction: states are dicts char → next state."""

    def __init__(self) -> None:
        self.trans: List[Dict[str, int]] = []
        self.accept: set = set()

    def new_state(self) -> int:
        self.trans.append({})
        return len(self.trans) - 1

    def add(self, src: int, chars: str, dst: int) -> None:
        for ch in chars:
            self.trans[src][ch] = dst

    def literal(self, src: int, text: str) -> int:
        cur = src
        for ch in text:
            nxt = self.trans[cur].get(ch)
            if nxt is None:
                nxt = self.new_state()
                self.trans[cur][ch] = nxt
            cur = nxt
        return cur

    def string_value(self, src: int, max_len: int) -> int:
        """``"`` up to ``max_len`` content chars ``"``. Bounded so decode can
        never burn the whole token budget inside one value — at the cap only
        the closing quote is legal, forcing structural progress."""
        content = self.literal(src, '"')
        end = self.new_state()
        cur = content
        for _ in range(max_len):
            nxt = self.new_state()
            self.add(cur, _STR_CHARS, nxt)
            self.trans[cur]['"'] = end
            cur = nxt
        self.trans[cur]['"'] = end  # cap state: quote only
        return end

    def _digit_run(self, starts: List[int], max_digits: int) -> List[int]:
        """A SHARED chain of 1..max_digits digit states reachable from every
        state in ``starts``; returns the accepting chain states. Sharing one
        chain (instead of a chain per predecessor) keeps the DFA a few
        hundred states — the token table is O(states × vocab)."""
        chain: List[int] = []
        first = self.new_state()
        chain.append(first)
        for s in starts:
            self.add(s, _DIGITS, first)
        cur = first
        for _ in range(max_digits - 1):
            nxt = self.new_state()
            self.add(cur, _DIGITS, nxt)
            chain.append(nxt)
            cur = nxt
        return chain

    def number(self, src: int, max_digits: int) -> None:
        """``-?d{1,m}(.d{1,m})?([eE][+-]?d{1,3})?`` — bounded digit runs (see
        :meth:`string_value`). Wire delimiters via :meth:`link_delims`."""
        n_sign_d = self.new_state()
        self.add(src, "-", n_sign_d)
        # JSON int part: "0" or [1-9][0-9]* — a bare leading zero cannot be
        # followed by more digits (json.loads rejects "007")
        n_zero = self.new_state()
        n_first = self.new_state()
        for s in (src, n_sign_d):
            self.add(s, "0", n_zero)
            self.add(s, "123456789", n_first)
        int_states = [n_zero, n_first] + (
            self._digit_run([n_first], max_digits - 1) if max_digits > 1 else []
        )
        n_dot = self.new_state()
        for s in int_states:
            self.add(s, ".", n_dot)
        frac_states = self._digit_run([n_dot], max_digits)
        n_e = self.new_state()
        for s in int_states + frac_states:
            self.add(s, "eE", n_e)
        n_es = self.new_state()
        self.add(n_e, "+-", n_es)
        exp_states = self._digit_run([n_e, n_es], 3)
        self._num_accepting = tuple(int_states + frac_states + exp_states)

    def link_delims(self, delim: str, dst: int) -> None:
        for s in self._num_accepting:
            self.add(s, delim, dst)


def build_action_json_dfa(max_str: int = 32, max_digits: int = 6) -> _DFA:
    """DFA for the canonical RoomPlan action object (json.dumps layout).

    Value lengths are bounded (``max_str`` string chars, ``max_digits`` per
    digit run) so the complete object always fits a known budget: worst case
    ≈ ``22 + 2·(max_str+2) + 3·(14 + 3·(2·max_digits+8) + 4) + 1`` chars
    (≈ 310 at the defaults) — give ``max_new_tokens`` at least that many
    byte-level tokens (real BPE needs far fewer).
    """
    d = _DFA()
    s = d.new_state()  # 0 = start
    cur = d.literal(s, '{"action": ')
    cur = d.string_value(cur, max_str)
    cur = d.literal(cur, ', "scene": ')
    cur = d.string_value(cur, max_str)
    for key in ("center", "normal", "extent"):
        cur = d.literal(cur, f', "{key}": [')
        for j in range(3):
            d.number(cur, max_digits)
            nxt = d.new_state()
            d.link_delims("," if j < 2 else "]", nxt)
            cur = nxt
            if j < 2:
                # json.dumps puts one space after the comma
                cur = d.literal(cur, " ")
    end = d.literal(cur, "}")
    d.accept.add(end)
    return d


# ---------------------------------------------------------------------------
# Tokenizer compilation
# ---------------------------------------------------------------------------


def _token_strings(tokenizer) -> List[Optional[str]]:
    """Surface string per vocab id (None = never usable, e.g. specials)."""
    n = len(tokenizer)
    out: List[Optional[str]] = [None] * n
    special_ids = set()
    for attr in ("all_special_ids",):
        special_ids.update(getattr(tokenizer, attr, []) or [])
    for i in range(n):
        if i in special_ids:
            continue
        try:
            # skip_special_tokens=True so added specials (<image>, <eos>…)
            # decode to "" and stay forbidden — EOS is wired explicitly
            s = tokenizer.decode([i], skip_special_tokens=True)
        except Exception:  # noqa: BLE001 — unusable id
            continue
        out[i] = s if s else None
    return out


def compile_constraint_table(
    tokenizer, dfa: Optional[_DFA] = None, vocab_size: Optional[int] = None
) -> np.ndarray:
    """→ dense transition table [num_states + 1, vocab] int16, −1 = forbidden.

    Row layout: DFA states first, then one terminal *sink* row. EOS is legal
    only from accepting states (→ sink); the sink allows only EOS/pad (so
    finished rows keep emitting pads legally). Compiled once per tokenizer:
    for a 152k-vocab tokenizer this walks every token string through the DFA
    (seconds, with the first-character pruning below).

    ``vocab_size``: pad the column count to the MODEL's vocab (model vocabs
    are padded past the tokenizer's, e.g. Qwen3 151,936 vs 151,669 tokenizer
    ids) — the extra columns stay −1 (forbidden).
    """
    dfa = dfa or build_action_json_dfa()
    strings = _token_strings(tokenizer)
    S = len(dfa.trans)
    V = max(len(strings), vocab_size or 0)
    sink = S
    # int16: ~320 states ≪ 32k, and the table is O(states × vocab) device
    # memory — ~100 MB at the 152k Qwen3 vocab instead of 200 MB in int32
    table = np.full((S + 1, V), -1, np.int16)

    def walk(state: int, text: str) -> int:
        for ch in text:
            nxt = dfa.trans[state].get(ch)
            if nxt is None:
                return -1
            state = nxt
        return state

    for tid, text in enumerate(strings):
        if text is None:
            continue
        first = text[0]
        for state in range(S):
            # pruning: skip states that can't consume the first char
            if first not in dfa.trans[state]:
                continue
            table[state, tid] = walk(state, text)

    eos = getattr(tokenizer, "eos_token_id", None)
    pad = getattr(tokenizer, "pad_token_id", None)
    if eos is not None:
        for state in dfa.accept:
            table[state, eos] = sink
        table[sink, eos] = sink
    if pad is not None:
        table[sink, pad] = sink

    # Coverage check: every state reachable from 0 must allow ≥1 token.
    # A tokenizer lacking coverage for some transition char would leave an
    # all −1 row; greedy would then silently emit token 0 and the engine's
    # state clamp would reset the FSM — garbage output with no error.
    reachable = {0}
    stack = [0]
    while stack:
        row = table[stack.pop()]
        for nxt in np.unique(row[row >= 0]):
            if int(nxt) not in reachable:
                reachable.add(int(nxt))
                stack.append(int(nxt))
    dead = sorted(s for s in reachable if not (table[s] >= 0).any())
    if dead:
        raise ValueError(
            f"constraint table has reachable state(s) with no allowed token: "
            f"{dead} — the tokenizer cannot express some DFA transition "
            f"(accepting states also need eos_token_id to terminate)"
        )
    return table


def action_json_constraint(tokenizer, vocab_size: Optional[int] = None) -> np.ndarray:
    """The ready-to-use constraint table for ``engine.generate``."""
    return compile_constraint_table(tokenizer, build_action_json_dfa(), vocab_size)
