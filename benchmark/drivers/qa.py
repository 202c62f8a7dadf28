"""Driver of the offline QA cells: batched ScanQA-style questions as the QA
CLI (``inference/qa.py``) answers them.

The program: seeded bf16 weights (``benchmark/weights``, no adapters, no
quantization: the CLI's defaults), and a step of the window is one batch:
``batching.spliced_prompt`` (VGGT → Perceiver → embed → the expanding
splice) then ``engine.generate_early_exit`` (greedy, repetition penalty
1.1, the byte tokenizer's EOS, a bf16 cache), closed loop, one batch in
flight.

Inputs, made in set-up from the seed: a pool of batches, each of ``batch``
samples with ``views`` views uniform in [0, 1] at the configuration's image
size (on the card), and a question of 8–20 words drawn from the cell's word
list into the CLI's prompt ``f"{question}\\n<image>\\n"``, encoded as the
byte tokenizer encodes it (UTF-8 bytes, ``<eos>`` 256, ``<image>`` 257) and
left-padded with ``<eos>`` to the pool's longest prompt. Set-up answers one
batch of each shape the window runs (the warm-up).

The check (:meth:`Session.check`): once the window has closed, a sample of
the answered questions drawn from the seed, the longest answers among them,
is run through ``benchmark/reference/qa.py`` once each; the number compared
is the widest gap by which a served token's (penalized) logit lies below
the reference's best at its position.
"""

from __future__ import annotations

import random
from typing import List

import torch

from .. import counts, program, weights
from ..reference import model as ref_model
from ..reference import qa as ref_qa
from ..run import log
from ..trace import Recorder

EOS, IMAGE = 256, 257


def end_to_end(work: dict, window_s: float) -> dict:
    return {"qa_samples_per_s": work["samples"] / window_s}


def encode(text: str) -> List[int]:
    """The byte tokenizer's ids of a prompt: ``<image>`` one id, the rest UTF-8 bytes."""
    parts = text.split("<image>")
    ids: List[int] = []
    for i, part in enumerate(parts):
        if i:
            ids.append(IMAGE)
        ids.extend(part.encode("utf-8"))
    return ids


def questions(spec: dict, n: int, rng: random.Random) -> List[List[int]]:
    words = spec["words"]
    lo, hi = spec["question_words"]
    return [encode(" ".join(rng.choice(words) for _ in range(rng.randint(lo, hi))) + "?\n<image>\n")
            for _ in range(n)]


class Session:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cfg, self.spec, self.seed, self.dev = cell["config"], cell["spec"], seed, device
        self.B, self.V = self.spec["batch"], self.cfg["num_views"]
        self.new = self.spec["max_new_tokens"]

    def setup(self) -> None:
        from vggt_qwen3_tpu_torch.inference.engine import GenerationConfig

        cfg, spec = self.cfg, self.spec
        self.stage = program.stage(cfg, rows=self.B)
        self.params = weights.make(cfg, self.seed, self.dev)
        log("weights made")
        rng = random.Random(self.seed)
        g = torch.Generator(device=self.dev).manual_seed((self.seed * 2 + 1) % (1 << 63))
        S, dt = cfg["image_size"], weights.DTYPES[cfg["dtype"]]
        qs = [questions(spec, self.B, rng) for _ in range(spec["pool"])]
        width = max(len(q) for batch in qs for q in batch)
        self.pool = []
        for batch in qs:
            ids = torch.full((self.B, width), EOS, dtype=torch.long)
            mask = torch.zeros((self.B, width), dtype=torch.int32)
            for r, q in enumerate(batch):
                ids[r, width - len(q):] = torch.tensor(q)
                mask[r, width - len(q):] = 1
            images = torch.rand((self.B, self.V, 3, S, S), generator=g, device=self.dev).to(dt)
            self.pool.append({"images": images, "ids": ids.to(self.dev), "mask": mask.to(self.dev), "questions": batch})
        self.gen_cfg = GenerationConfig(max_new_tokens=self.new, eos_token_id=EOS, pad_token_id=EOS,
                                        repetition_penalty=spec["repetition_penalty"], penalize_prompt=False)
        self.answers = []
        for i in range(spec["pool"]):  # every batch's shapes, once
            self.step(i, Recorder(False))
            log(f"warm-up batch {i}")
        self.answers = []

    def _batch(self, b: dict, rec):
        from vggt_qwen3_tpu_torch.inference import batching
        from vggt_qwen3_tpu_torch.inference.engine import generate_early_exit

        with rec.span("vision", after="generate"):
            embeds, mask2 = batching.spliced_prompt(self.params, self.stage, IMAGE, b["images"], b["ids"], b["mask"])
        with rec.span("generate"):
            tokens, lengths, steps = generate_early_exit(self.params["text"], self.stage.model.text, self.gen_cfg,
                                                         inputs_embeds=embeds, attention_mask=mask2)
        return tokens, lengths, steps, int(mask2.shape[1])

    def step(self, i: int, rec) -> dict:
        b = self.pool[i % len(self.pool)]
        tokens, lengths, steps, width = self._batch(b, rec)
        self.answers.append((i % len(self.pool), tokens, lengths))
        valid = [len(q) - 1 + self.cfg["num_vis_tokens"] for q in b["questions"]]
        return {"samples": self.B, "attempted": self.B, "batches": 1, "decode_steps": steps,
                "flops": counts.qa_batch_flops(self.cfg, valid, steps),
                "bound_s": {"flash_fwd": counts.qa_flash_bound_s(self.cfg, valid),
                            "decode_attention": counts.qa_decode_bound_s(self.cfg, valid, steps)},
                "launches": {"flash_fwd": len(counts.qa_flash_launches(self.cfg, self.B, width)),
                             "decode_attention": self.cfg["text"]["num_layers"] * steps}}

    def release(self) -> None:
        del self.params

    def picks(self) -> List[tuple]:
        """The answers the check runs: drawn from the seed among the longest."""
        rng = random.Random(self.seed ^ 0x5A17)
        answered = [(k, r) for k in range(len(self.answers)) for r in range(self.B)]
        longest = max(int(self.answers[k][2][r]) for k, r in answered)
        chosen = [kr for kr in answered if int(self.answers[kr[0]][2][kr[1]]) == longest]
        return rng.sample(chosen, min(self.spec["checked"], len(chosen)))

    def gaps(self, precs: List[ref_model.Prec]) -> List[float]:
        """For each precision, the widest gap by which the token it puts first
        at each position of the checked answers (the served token itself for
        the program, ``precs[0]`` the float32 reference) lies below the
        float32 reference's best, there and after the same served tokens."""
        picks = self.picks()
        log(f"reference over {len(picks)} answers")
        ref_model.strict_float32()
        w = weights.make(self.cfg, self.seed, self.dev)
        w["projector"] = ref_model.as_f32(w["projector"])
        out = [0.0] * len(precs)
        for k, r in picks:
            pool_i, tokens, lengths = self.answers[k]
            b = self.pool[pool_i]
            served = [int(t) for t in tokens[r][:int(lengths[r])]]
            logits = [ref_qa.served_logits(w, self.cfg, b["images"][r], b["questions"][r], served, IMAGE,
                                           self.spec["repetition_penalty"], p) for p in precs]
            ref, best = logits[0], logits[0].max(dim=1).values
            chosen = [torch.tensor(served, device=ref.device)] + [x.argmax(dim=1) for x in logits[1:]]
            for j, tok in enumerate(chosen):
                out[j] = max(out[j], float((best - ref.gather(1, tok[:, None])[:, 0]).max()))
        log("reference done")
        return out

    def check(self) -> List[tuple]:
        return [("logit_gap", self.gaps([ref_model.Prec()])[0], self.spec["limits"]["logit_gap"])]
