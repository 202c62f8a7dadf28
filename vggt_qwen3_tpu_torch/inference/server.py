"""The QA serving daemon (counterpart of ``vggt_qwen3_tpu/inference/server.py``).

Two engines:

- ``--engine slots`` (default): token-level continuous batching over KV
  slots with mid-decode admission (``inference/slots.py``). A request
  arriving while others decode is spliced on its HTTP handler's thread,
  prefilled into a free slot and joins within one decode chunk.
- ``--engine batch``: batch-boundary coalescing — a batcher thread groups
  requests (up to ``--max_batch`` / ``--max_wait_ms``) and runs the spliced
  generation of ``inference/batching.py``.

Requests pad to the prompt bucket either way. Greedy decoding with
repetition penalty 1.1, the answer heuristics of ``postprocess_qa_answer``.
The text model serves W8 weights by default (``--quantize w8``:
``qwen3.quantize_params``; ``w8a8`` adds int8 activations, ``w4`` packs
group-int4 weights, ``none`` keeps bf16) and the KV cache is int8;
``--quantize_vision w8|w8a8`` quantizes the frozen VGGT tower's block
projections (``vlm.quantize_vision``). The flags apply to ``--tiny`` models
too (the JAX server skips them there), so the CPU tests serve every mode.

    python -m vggt_qwen3_tpu_torch.inference.server --config configs/stage1_3d.yaml \\
        [--checkpoint_dir DIR | --random_full | --tiny --mock_vision] [--port 8765] \\
        [--engine slots|batch] [--kv_dtype int8|bf16] [--speculative] [--device cuda]

    curl -s localhost:8765/healthz
    curl -s -X POST localhost:8765/v1/qa -d '{"question": "What color is the room?",
        "images": ["data/toy/images/scene000_v0.jpg"]}'

The device is ``cuda`` unless ``--device cpu`` is given; without a card the
server raises.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..data.tokenizer import IMAGE_TOKEN, load_tokenizer
from .batching import encode_prompts, generate_batch, spliced_prompt, stack_views
from .engine import GenerationConfig
from .postprocess import postprocess_qa_answer
from .qa import build_stage, load_model

QUANT_MODES = ("none", "w8", "w8a8", "w4")
VISION_QUANT_MODES = ("none", "w8", "w8a8")


def load_images(paths: List[str]) -> List[np.ndarray]:
    """A request's views as RGB uint8 arrays (PIL, imported here). A missing
    file raises ``FileNotFoundError``, which the handler answers with 400."""
    from PIL import Image

    return [np.asarray(Image.open(p).convert("RGB")) for p in paths]


def _gen_cfg(tokenizer, max_new_tokens: int, kv_dtype: str) -> GenerationConfig:
    return GenerationConfig(
        max_new_tokens=max_new_tokens,
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id,
        repetition_penalty=1.1,
        kv_dtype=None if kv_dtype in ("bf16", "bfloat16") else kv_dtype,
    )


class QAService:
    """Batch-boundary coalescing (``--engine batch``)."""

    def __init__(self, stage, tokenizer, params, *, max_batch: int, max_wait_ms: float,
                 max_new_tokens: int, prompt_bucket: int, kv_dtype: str = "int8") -> None:
        self.stage = stage
        self.tokenizer = tokenizer
        self.params = params
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.prompt_bucket = prompt_bucket
        self.gen_cfg = _gen_cfg(tokenizer, max_new_tokens, kv_dtype)
        self.queue: "queue.Queue[tuple[Dict, Future]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0}
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._batcher, daemon=True)
        self.thread.start()

    def submit(self, request: Dict) -> Future:
        fut: Future = Future()
        self.queue.put((request, fut))
        return fut

    def _batcher(self) -> None:
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.time() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._run(batch)

    def _run(self, batch: List) -> None:
        requests = [r for r, _ in batch]
        futures = [f for _, f in batch]
        try:
            samples = [{"images": load_images(r["images"])[: self.stage.data.num_views]} for r in requests]
            questions = [r.get("question", "") for r in requests]
            prompts = [f"{q}\n{IMAGE_TOKEN}\n" for q in questions]
            tokens, lengths = generate_batch(
                self.params, self.stage, self.tokenizer, samples, prompts, self.gen_cfg,
                pad_to_len=self.prompt_bucket, pad_to_batch=self.max_batch,
            )
            self.stats["requests"] += len(requests)
            self.stats["batches"] += 1
            for i, fut in enumerate(futures):
                raw = self.tokenizer.decode(tokens[i][: lengths[i]], skip_special_tokens=True)
                fut.set_result({"prediction": postprocess_qa_answer(raw, questions[i])})
        except Exception as e:  # every waiting request gets the error
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=5)


class SlotQAService:
    """Token-level continuous batching (``inference/slots.py``): each request
    is vision-encoded and spliced on the caller's thread, prefilled into a
    free KV slot and decoded beside whatever else is in flight."""

    def __init__(self, stage, tokenizer, params, *, num_slots: int, max_new_tokens: int, prompt_bucket: int,
                 decode_chunk: int = 4, kv_dtype: str = "int8", speculative: bool = False, draft_k: int = 6,
                 ngram: int = 3, spec_chunk: int = 4, track_metrics: bool = False) -> None:
        from .slots import SlotEngine

        self.stage = stage
        self.tokenizer = tokenizer
        self.params = params
        self.device = params["text"]["final_norm"].device
        self.prompt_bucket = prompt_bucket
        self.gen_cfg = _gen_cfg(tokenizer, max_new_tokens, kv_dtype)
        # spliced prompt length = bucket + num_vis − 1 (+ geom span)
        vis_span = stage.model.num_vis_tokens + stage.model.geom_tokens
        max_len = prompt_bucket + vis_span - 1 + max_new_tokens
        self.speculative = speculative
        self.engine = SlotEngine(
            params["text"], stage.model.text, self.gen_cfg,
            num_slots=num_slots, max_len=max_len, decode_chunk=decode_chunk,
            speculative=speculative, draft_k=draft_k, ngram=ngram, spec_chunk=spec_chunk,
            track_metrics=track_metrics,
        )
        self.image_token_id = tokenizer.convert_tokens_to_ids(IMAGE_TOKEN)
        self.engine.start()

    @property
    def stats(self) -> Dict:
        s = self.engine.stats
        return {"requests": s.requests, "chunks": s.chunks, "admitted_mid_decode": s.admitted_mid_decode,
                "tokens": s.tokens}

    def splice(self, question: str, images: List[np.ndarray]):
        """One request's prompt → (embeds [1, S', H], mask [1, S'], the text
        ids [1, bucket] with zeros on the pads) on the service's device."""
        ids, mask = encode_prompts(self.tokenizer, [f"{question}\n{IMAGE_TOKEN}\n"], pad_to_len=self.prompt_bucket)
        views = stack_views([{"images": images[: self.stage.data.num_views]}], self.stage.data.image_size,
                            self.device)
        ids_t, mask_t = torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
        embeds, mask2 = spliced_prompt(self.params, self.stage, self.image_token_id, views, ids_t, mask_t)
        return embeds, mask2, ids_t * mask_t

    def submit(self, request: Dict) -> Future:
        outer: Future = Future()
        try:
            question = request.get("question", "")
            embeds, mask, lookup = self.splice(question, load_images(request["images"]))
            req_budget = request.get("max_new_tokens")
            if req_budget is not None:
                req_budget = min(int(req_budget), self.gen_cfg.max_new_tokens)
            # speculative draft memory: the TEXT prompt ids, zeros on the pads
            inner = self.engine.submit_embeds(embeds, mask, max_new_tokens=req_budget,
                                              lookup_ids=lookup if self.speculative else None)
        except Exception as e:
            outer.set_exception(e)
            return outer

        def finish(fut):
            try:
                toks, n = fut.result()
                raw = self.tokenizer.decode(toks[:n], skip_special_tokens=True)
                outer.set_result({"prediction": postprocess_qa_answer(raw, question)})
            except Exception as e:  # the HTTP handler answers it
                outer.set_exception(e)

        inner.add_done_callback(finish)
        return outer

    def stop(self) -> None:
        self.engine.stop()


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", **service.stats})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/v1/qa":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                request = json.loads(self.rfile.read(length) or b"{}")
                if not request.get("question") or not request.get("images"):
                    self._send(400, {"error": "required fields: question, images"})
                    return
                result = service.submit(request).result(timeout=300)
                self._send(200, result)
            except FileNotFoundError as e:
                self._send(400, {"error": f"image not found: {e}"})
            except Exception as e:
                self._send(500, {"error": str(e)})

    return Handler


def build_service(args):
    """The stage, tokenizer, params (quantized as asked) and service of the
    parsed arguments, on ``args.device``."""
    dev = resolve_device(args.device)
    stage = build_stage(args)
    tokenizer = load_tokenizer(None if args.tiny else stage.tokenizer_path or stage.text_model_name)
    params = load_model(stage, args.checkpoint_dir, device=dev)
    if args.quantize != "none":
        from ..models import qwen3

        params = dict(params, text=qwen3.quantize_params(dict(params["text"]), mode=args.quantize))
    if args.quantize_vision != "none":
        from ..models import vlm

        params = vlm.quantize_vision(params, mode=args.quantize_vision)
    if args.engine == "slots":
        service = SlotQAService(
            stage, tokenizer, params,
            num_slots=args.max_batch, max_new_tokens=args.max_new_tokens,
            prompt_bucket=args.prompt_bucket, decode_chunk=args.decode_chunk,
            kv_dtype=args.kv_dtype, speculative=args.speculative,
            draft_k=args.draft_k, spec_chunk=args.spec_chunk,
        )
    else:
        service = QAService(
            stage, tokenizer, params,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_new_tokens=args.max_new_tokens, prompt_bucket=args.prompt_bucket,
            kv_dtype=args.kv_dtype,
        )
    return service


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="QA serving daemon (PyTorch/CUDA port).")
    ap.add_argument("--config", default="configs/stage1_3d.yaml")
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--engine", choices=["slots", "batch"], default="slots",
                    help="slots = token-level continuous batching (mid-decode admission); "
                         "batch = batch-boundary coalescing")
    ap.add_argument("--max_batch", type=int, default=8,
                    help="batch engine: coalescing cap; slots engine: number of KV slots")
    ap.add_argument("--max_wait_ms", type=float, default=50.0)
    ap.add_argument("--decode_chunk", type=int, default=4,
                    help="slots engine: tokens decoded between admission checks")
    ap.add_argument("--max_new_tokens", type=int, default=32)
    ap.add_argument("--prompt_bucket", type=int, default=64)
    ap.add_argument("--kv_dtype", choices=["int8", "bf16"], default="int8")
    ap.add_argument("--speculative", action="store_true",
                    help="slots engine: prompt-lookup verify blocks, 1..k+1 tokens a weight read (same tokens)")
    ap.add_argument("--draft_k", type=int, default=6, help="--speculative: drafted tokens a verify block")
    ap.add_argument("--spec_chunk", type=int, default=4, help="--speculative: verify blocks a chunk")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mock_vision", action="store_true")
    ap.add_argument("--random_full", action="store_true", help="full-size model with seeded random weights")
    ap.add_argument("--quantize_vision", choices=VISION_QUANT_MODES, default="none",
                    help="frozen VGGT tower: w8 = int8 block weights, w8a8 = int8 activations too")
    ap.add_argument("--quantize", choices=QUANT_MODES, default="w8",
                    help="text model weights at load: w8 = int8 (default), w8a8 = int8 activations too, "
                         "w4 = group-int4 storage, none = bf16 (the KV cache follows --kv_dtype)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    service = build_service(args)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(service))
    print(f"serving on :{server.server_address[1]} (engine {args.engine}, max_batch "
          f"{args.max_batch}, kv {args.kv_dtype}, device {args.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.stop()


if __name__ == "__main__":
    main()
