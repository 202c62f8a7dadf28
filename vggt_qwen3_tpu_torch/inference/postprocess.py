"""Answer post-processing heuristics — part of the observable behavior the
published EM numbers flow through, reproduced exactly.

QA (``src/inference/qa_inference.py:220-243``): strip echoed question, drop
``<image>``, keep the first sentence, and if still > 5 words take the text
after the last " is ".

ARKit (``src/inference/arkit_inference.py:147-179``): strip the prompt echo,
then extract the first balanced ``{...}`` JSON object via brace matching.
"""

from __future__ import annotations

from typing import Optional


def postprocess_qa_answer(text: str, question: str) -> str:
    if text.startswith(question):
        text = text[len(question):].strip()
    text = text.replace("<image>", "").strip()
    if "." in text:
        text = text.split(".")[0].strip()
    if len(text.split()) > 5:
        if " is " in text.lower():
            parts = text.lower().split(" is ")
            if len(parts) >= 2:
                text = parts[-1].strip()
    return text


def postprocess_arkit_generation(raw_text: str, prompt_text: str, question: str) -> str:
    """ARKit generation cleanup (``arkit_inference.py:147-163``): strip the
    echoed prompt then the bare question, drop ``<image>``; if that empties
    the string, fall back to the raw text."""
    raw_text = raw_text.strip()
    cleaned = raw_text
    for prefix in (prompt_text.strip(), question):
        if cleaned.startswith(prefix):
            cleaned = cleaned[len(prefix):].strip()
    cleaned = cleaned.replace("<image>", "").strip()
    return cleaned if cleaned else raw_text


def extract_first_json(text: str) -> str:
    """First balanced ``{...}`` object; the input unchanged when none is found
    (``arkit_inference.py:166-179`` returns ``text``, not None)."""
    start = text.find("{")
    if start == -1:
        return text
    depth = 0
    for i in range(start, len(text)):
        ch = text[i]
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return text[start : i + 1]
    return text
