"""One rank of the port's ring-attention checks on the CPU (gloo), started by
``tests/test_torch_ring_attention.py`` once per rank:

    python tests/torch_ring_ranks.py RANK WORLD DIR

It reads ``DIR/inputs.pt``, joins the group through a file store in DIR and
writes ``DIR/rank<RANK>.pt``:

- ``ring``: ``ring_attention_sharded`` of the full q, k, v (every rank holds
  the whole output);
- ``dq``, ``dk``, ``dv``: this rank's shards of the gradients of
  ``sum(tanh(o)·w)`` summed over the ranks, ``o`` the output of
  ``ring_attention`` on each rank's shards;
- ``agg``: the VGGT aggregator's last pair with ``ring_group`` set.

It imports no JAX: the test holds these to the JAX package in its own
process.
"""

import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vggt_qwen3_tpu_torch.config import VGGTConfig  # noqa: E402
from vggt_qwen3_tpu_torch.models import vggt  # noqa: E402
from vggt_qwen3_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded  # noqa: E402


def main(rank: int, world: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    inp = torch.load(out_dir / "inputs.pt")
    dist.init_process_group("gloo", store=dist.FileStore(str(out_dir / "store"), world), rank=rank,
                            world_size=world)
    try:
        res = {}
        with torch.no_grad():
            res["ring"] = ring_attention_sharded(inp["q"], inp["k"], inp["v"])

        g = inp["grad"]
        n = g["q"].shape[1] // world
        local = {name: g[name][:, rank * n:(rank + 1) * n].clone().requires_grad_(True) for name in ("q", "k", "v")}
        o = ring_attention(local["q"], local["k"], local["v"])
        (torch.tanh(o) * g["w"][:, rank * n:(rank + 1) * n]).sum().backward()
        res.update({f"d{name}": t.grad for name, t in local.items()})

        with torch.no_grad():
            cfg = VGGTConfig(**inp["agg_cfg"])
            res["agg"] = vggt.aggregator(inp["agg_params"], cfg, inp["images"], ring_group=dist.group.WORLD)[0][-1]
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "vggt_qwen3_tpu") for m in sys.modules)
        torch.save(res, out_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
