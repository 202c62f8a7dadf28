"""Driver of the QLoRA training cells.

The program's training step as the recipe runs it on one card: seeded
weights (``benchmark/weights``) with LoRA adapters, the VGGT tower quantized
by ``vlm.quantize_vision`` (W8A8), the Qwen3 base by ``qwen3.quantize_params``
(W8) with the adapters re-attached, ``trainer.Optimizer`` (8-bit AdamW, the
recipe's two groups, schedule, clip and frozen layers) over the trainable
leaves. A step of the window is one micro step: ``vlm.train_forward``, its
gradients, and ``Optimizer.update`` (which applies an update every
``grad_accum``-th micro step).

Inputs: a pool of ``grad_accum`` batches made on the card
from the seed (views uniform in [0, 1], ids uniform below the last id, which
is ``<image>``, set at position 4; the first 8 labels masked; geometry
features standard normal), cycled by the window. Micro step ``i`` draws the
Perceiver's dropout from a generator seeded by (seed, i).

The schedule starts at the end of its warm-up (the learning rate at its
peak), as a run resumed there with fresh moments: from step 0 the
warm-up's first updates are far below the round-off of bfloat16 weights,
so no change of a weight could be compared.

Set-up runs the first ``grad_accum`` micro steps (up to the first update)
through the same call — the warm-up of every shape — and keeps what the check
compares: each trainable leaf's first gradient as the
optimizer holds it after one micro step (its accumulator), and each leaf's
change by the first update (``benchmark/compare.py`` says why the first). The check (:meth:`Session.check`) follows the
same micro steps with ``benchmark/reference`` and compares, leaf by leaf,
the gaps between the norms.
"""

from __future__ import annotations

from typing import List

import torch

from .. import compare, counts, program, weights
from ..run import log
from ..trace import Recorder
from ..reference import model as ref_model
from ..reference import train as ref_train

IMAGE_AT = 4
MASKED_LABELS = 8


def end_to_end(work: dict, window_s: float) -> dict:
    return {"train_tokens_per_s": work["tokens"] / window_s}


def start_update(cfg: dict) -> int:
    """The schedule's count the cell trains at: the end of the warm-up, the
    learning rate at its peak (a run resumed there with fresh moments)."""
    return max(int(cfg["warmup_ratio"] * cfg["max_steps"]), 1)


def gen_seed(seed: int, i: int) -> int:
    """The dropout generator's seed of micro step ``i``."""
    return (seed * 1_000_003 + 7919 * i + 1) % (1 << 63)


def make_batches(cfg: dict, rows: int, n: int, seed: int, device) -> List[dict]:
    """``n`` training batches from ``seed``, made on ``device``."""
    g = torch.Generator(device=device).manual_seed((seed * 2 + 1) % (1 << 63))
    V, S, T, vocab = cfg["num_views"], cfg["image_size"], cfg["max_length"], cfg["text"]["vocab_size"]
    dt = weights.DTYPES[cfg["dtype"]]
    img_id = vocab - 1
    out = []
    for _ in range(n):
        images = torch.rand((rows, V, 3, S, S), generator=g, device=device).to(dt)
        ids = torch.randint(1, img_id, (rows, T), generator=g, device=device)
        ids[:, IMAGE_AT] = img_id
        labels = ids.clone()
        labels[:, :MASKED_LABELS] = -100
        geom = {k: torch.randn((rows, V, n_k), generator=g, device=device) for k, n_k in ref_model.GEOM_KEYS}
        out.append(dict(pixel_values=images, input_ids=ids, labels=labels, geom_token=geom, image_token_id=img_id,
                        attention_mask=torch.ones((rows, T), dtype=torch.int32, device=device)))
    return out


class Session:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cfg, self.spec, self.seed, self.dev = cell["config"], cell["spec"], seed, device
        self.rows = self.spec.get("rows", self.cfg["batch_size_per_gpu"])
        self.first = self.cfg["grad_accum"]
        self.start_update = start_update(self.cfg)
        self.tokens_per_step = self.rows * self.cfg["max_length"]
        self.flops_per_step = counts.train_step_flops(self.cfg, self.rows)
        launches = counts.train_flash_launches(self.cfg, self.rows)
        self.flash_per_step = len(launches)
        self.flash_bound_s = sum(counts.flash_fwd_bound_s(s, c) for s, c in launches)

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from vggt_qwen3_tpu_torch.models import qwen3, vlm
        from vggt_qwen3_tpu_torch.train import trainer

        cfg = self.cfg
        self.stage = program.stage(cfg, rows=self.rows)
        params = weights.make(cfg, self.seed, self.dev, lora=True)
        log("weights made")
        if cfg["vision_quant"] != "none":
            params = vlm.quantize_vision(params, mode=cfg["vision_quant"])
        if cfg["text_quant"] != "none":
            lora = params["text"]["layers"]["lora"]
            params["text"] = qwen3.quantize_params(params["text"], mode=cfg["text_quant"])
            params["text"]["layers"]["lora"] = lora
        labels = trainer.param_group_labels(params, cfg["freeze_vision"], lora=True)
        self.params = params
        self.trainable = {n: t for n, t in trainer.named_leaves(params) if labels[n] != "frozen"}
        self.tx = trainer.Optimizer(self.stage.train, labels, freeze_text_layers=self.stage.freeze_text_layers,
                                    num_text_layers=cfg["text"]["num_layers"])
        self.opt_state = self.tx.init(params)
        self.opt_state["gradient_step"] = self.start_update
        self.pool = make_batches(cfg, self.rows, self.first, self.seed, self.dev)
        log("frozen weights quantized, optimizer and inputs made")

        start = {n: t.detach().to("cpu", copy=True) for n, t in self.trainable.items()}
        self.losses, self.change = [], None
        for i in range(self.first):
            loss, emitted = self._micro(i, Recorder(False))
            self.losses.append(float(loss))
            if i == 0:
                acc = self.opt_state["acc"]
                self.first_grad = {n: float(torch.linalg.vector_norm(acc[n].float())) for n in self.trainable}
                self.first_grads = {n: acc[n].to("cpu", copy=True) for n in self.trainable}
            if emitted and self.change is None:
                self.change = {n: float(torch.linalg.vector_norm(t.float() - start[n].to(t.device).float()))
                               for n, t in self.trainable.items()}
                del start
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            log(f"micro step {i}{' and the update' if emitted else ''}")

    def _micro(self, i: int, rec):
        from vggt_qwen3_tpu_torch.models import vlm

        b = self.pool[i % len(self.pool)]
        gen = torch.Generator(device=self.dev).manual_seed(gen_seed(self.seed, i))
        leaves = list(self.trainable.values())
        rec.phase("forward_backward")
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss = vlm.train_forward(self.params, self.stage.model, images=b["pixel_values"],
                                     geom_token=b["geom_token"], input_ids=b["input_ids"],
                                     attention_mask=b["attention_mask"], labels=b["labels"],
                                     image_token_id=b["image_token_id"], generator=gen)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = dict(zip(self.trainable, grads))
        with rec.span("optimizer"):
            emitted = self.tx.update(grads, self.opt_state, self.params)
        return loss.detach(), emitted

    # -- the window ----------------------------------------------------------

    def step(self, i: int, rec) -> dict:
        _, emitted = self._micro(self.first + i, rec)
        return {"tokens": self.tokens_per_step, "flops": self.flops_per_step, "attempted": 1,
                "updates": int(emitted), "bound_s": {"flash_fwd": self.flash_bound_s},
                "launches": {"flash_fwd": self.flash_per_step}}

    def release(self) -> None:
        """Free the program's state; the pool and what set-up kept stay."""
        del self.params, self.trainable, self.tx, self.opt_state

    # -- the check -----------------------------------------------------------

    def check(self) -> List[tuple]:
        log("reference")
        seeds = [gen_seed(self.seed, i) for i in range(self.first)]
        ref = ref_train.follow(self.cfg, self.seed, self.pool, seeds, self.dev, ref_model.Prec(),
                               start_update=self.start_update)
        log("reference done")
        got = {"losses": self.losses, "first_grad": self.first_grad, "first_grads": self.first_grads,
               "change": self.change}
        for what, detail in compare.report(got, ref).items():
            log(f"{what}: {detail}")
        return compare.training(got, ref, self.spec["limits"], self.dev)
