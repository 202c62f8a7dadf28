"""Multi-view collator, prefetching and the epoch-cycling loader (the port's own
copy of ``vggt_qwen3_tpu/data/collator.py``; pure Python and numpy, batches
equal to the JAX package's).

- per view: shorter-side resize → center crop → [0, 1] CHW float32
  (``ops.preprocess``; within one uint8 step of the JAX resize, equal where no
  resize is needed);
- prompt ``f"{question}\\n<image>\\n"`` with the answer appended (non-string
  answers JSON-serialised); labels −100 on the prompt and padding; sequences
  truncated to ``max_length`` before padding; right padding to ``pad_to`` or
  at least ``num_vis_tokens + geom_tokens + 64``;
- view dropout: each non-first view is dropped with probability
  ``view_dropout`` and the kept views are repeated back to the view count, the
  randomness a pure function of ``(seed, batch_index, row)``;
- the geom dict stacked with zero-fill where absent, plus a presence mask.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ..models.geom import FEATURE_SPLITS
from ..ops.preprocess import preprocess_views
from .tokenizer import IMAGE_TOKEN

GEOM_KEYS = tuple(FEATURE_SPLITS)


class MultiViewCollator:
    def __init__(
        self,
        image_size: int,
        tokenizer,
        max_length: int,
        num_vis_tokens: int = 128,
        geom_tokens: int = 8,
        view_dropout: float = 0.0,
        seed: int = 0,
        pad_to: Optional[int] = None,
        emit_geom: Optional[bool] = None,
    ) -> None:
        self.image_size = image_size
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.min_text_length = num_vis_tokens + geom_tokens + 64
        self.pad_to = pad_to
        self.view_dropout = view_dropout
        self.seed = seed
        # None → a geom batch iff any row carries geom; True/False → forced
        self.emit_geom = emit_geom

    def _encode(self, text: str) -> List[int]:
        return list(self.tokenizer(text, add_special_tokens=False)["input_ids"])

    def __call__(self, batch: List[Dict], batch_index: int = 0,
                 row_indices: Optional[List[int]] = None) -> Dict[str, Optional[np.ndarray]]:
        import random as _random

        if row_indices is None:
            row_indices = list(range(len(batch)))
        pixel, ids_list, labels_list, geoms = [], [], [], []
        for sample, row in zip(batch, row_indices):
            rng = _random.Random(((self.seed << 24) ^ batch_index) * 1_000_003 + row)
            images = list(sample["images"])
            if self.view_dropout > 0.0 and len(images) > 1:
                kept = [images[0]] + [im for im in images[1:] if rng.random() >= self.view_dropout]
                while len(kept) < len(images):  # keep the static view count
                    kept.append(kept[rng.randrange(len(kept))])
                images = kept
            pixel.append(preprocess_views(images, self.image_size, "cpu").numpy())
            answer_obj = sample["answer"]
            answer = answer_obj if isinstance(answer_obj, str) else json.dumps(answer_obj, ensure_ascii=False)
            prompt_ids = self._encode(f"{sample['question']}\n{IMAGE_TOKEN}\n")
            answer_ids = self._encode(answer)
            ids_list.append((prompt_ids + answer_ids)[: self.max_length])
            labels_list.append(([-100] * len(prompt_ids) + answer_ids)[: self.max_length])
            geoms.append(sample.get("geom_token"))

        pad_id = self.tokenizer.pad_token_id
        max_len = self.pad_to if self.pad_to is not None else max(
            max(len(i) for i in ids_list), self.min_text_length)
        input_ids = np.full((len(batch), max_len), pad_id, np.int32)
        labels = np.full((len(batch), max_len), -100, np.int32)
        for b, (ids, labs) in enumerate(zip(ids_list, labels_list)):
            input_ids[b, : len(ids)] = ids
            labels[b, : len(labs)] = labs
        attention_mask = (input_ids != pad_id).astype(np.int32)

        geom_batch = None
        emit_geom = self.emit_geom if self.emit_geom is not None else any(g is not None for g in geoms)
        if emit_geom:
            V = pixel[0].shape[0] if pixel else 1
            geom_batch = {}
            for key, width in FEATURE_SPLITS.items():
                rows = []
                for g in geoms:
                    if g is None or key not in g:
                        rows.append(np.zeros((V, width), np.float32))
                        continue
                    a = np.asarray(g[key], np.float32)
                    if a.shape[-1] != width:
                        raise ValueError(
                            f"geom_token[{key!r}] has width {a.shape[-1]}, expected {width} "
                            f"(FEATURE_SPLITS); offending record index {len(rows)} in this batch")
                    if a.ndim == 1:  # flat [k] → broadcast over views
                        a = np.broadcast_to(a, (V, width)).copy()
                    else:  # per-view [V', k] → pad/truncate to V
                        a = a[:V]
                        if a.shape[0] and a.shape[0] < V:
                            a = np.concatenate([a, np.repeat(a[-1:], V - a.shape[0], axis=0)])
                        elif not a.shape[0]:
                            a = np.zeros((V, width), np.float32)
                    rows.append(a)
                geom_batch[key] = np.stack(rows, axis=0)
            geom_batch["mask"] = np.asarray([g is not None for g in geoms], bool)

        return {
            "pixel_values": np.stack(pixel, axis=0),  # [B, V, 3, S, S]
            "geom_token": geom_batch,
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "labels": labels,
        }


def prefetch_iter(it, depth: int):
    """Run ``it`` on a background thread, keeping up to ``depth`` items ready
    in a bounded queue, in order. The collator's randomness keys off absolute
    (batch, row) indices, so the prefetched stream equals the synchronous one.
    Exceptions re-raise at the consumer; the producer is a daemon thread that
    stops once the consumer drops the iterator, and is joined at exit."""
    import atexit as _atexit
    import queue as _queue
    import threading as _threading

    q: "_queue.Queue" = _queue.Queue(maxsize=max(1, depth))
    _FAIL = object()
    stop = _threading.Event()

    def produce():
        try:
            src = iter(it)
            while not stop.is_set():
                item = next(src, StopIteration())
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except _queue.Full:
                        continue
                if isinstance(item, StopIteration):
                    return
        except BaseException as e:  # noqa: BLE001 — handed to the consumer, which re-raises it
            q.put((_FAIL, e))

    thread = _threading.Thread(target=produce, daemon=True)
    thread.start()

    def shutdown():
        stop.set()
        while True:  # drain so a blocked put() can observe the stop flag
            try:
                q.get_nowait()
            except _queue.Empty:
                break
        thread.join(timeout=30)

    _atexit.register(shutdown)

    def consume():
        while True:
            item = q.get()
            if isinstance(item, StopIteration):
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _FAIL:
                raise item[1]
            yield item

    return consume()


def data_loader(
    dataset,
    collator,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 42,
    start_batches: int = 0,
    shard_rank: int = 0,
    shard_count: int = 1,
    prefetch_batches: Optional[int] = None,
):
    """Epoch-cycling loader: collated numpy batches forever, drawn from a
    continuous shuffled index stream (``random.Random(seed)``) across epoch
    boundaries.

    ``start_batches`` fast-forwards the stream: batch ``start_batches`` of a
    resumed run equals that batch of an uninterrupted run (the index stream
    advances in pure Python, the dataset's stateful draws through
    ``consume_rng``). ``shard_rank``/``shard_count``: host r of a multi-host
    run materialises rows ``[r·B/count, (r+1)·B/count)`` of each global
    batch. ``prefetch_batches``: collate this many batches ahead on a thread
    (default 2; env ``VGGT_PREFETCH_BATCHES`` overrides, 0 = synchronous)."""
    import os as _os
    import random as _random

    if batch_size % shard_count != 0:
        raise ValueError(f"global batch {batch_size} not divisible by {shard_count} hosts")
    n = len(dataset)
    if n == 0:
        raise ValueError("empty dataset")

    def gen():
        rng = _random.Random(seed)

        def index_stream():
            while True:
                order = list(range(n))
                if shuffle:
                    rng.shuffle(order)
                yield from order

        stream = index_stream()
        consume = getattr(dataset, "consume_rng", None)
        for _ in range(start_batches * batch_size):
            idx = next(stream)
            if consume is not None:
                consume(idx)
        batch_index = start_batches
        while True:
            idxs = [next(stream) for _ in range(batch_size)]
            if shard_count == 1:
                yield collator([dataset[i] for i in idxs], batch_index=batch_index)
            else:
                local = batch_size // shard_count
                lo, hi = shard_rank * local, (shard_rank + 1) * local
                samples, rows = [], []
                for row, idx in enumerate(idxs):
                    if lo <= row < hi:
                        samples.append(dataset[idx])
                        rows.append(row)
                    elif consume is not None:
                        consume(idx)
                yield collator(samples, batch_index=batch_index, row_indices=rows)
            batch_index += 1

    depth = (int(_os.environ.get("VGGT_PREFETCH_BATCHES", "2"))
             if prefetch_batches is None else prefetch_batches)
    return prefetch_iter(gen(), depth) if depth > 0 else gen()
