"""The tiny sizes at which the CPU tests run a cell: every width and count
cut, the structure kept (two views resized from a larger position table,
grouped-query heads, adapters, two updates)."""

TEXT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            intermediate_size=128, rope_theta=10000.0, max_position_embeddings=2048)
VISION = dict(img_size=56, embed_dim=32, num_layers=2, num_heads=2, patch_depth=2)
PROJECTOR = dict(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128)


def shrink(cell: dict) -> None:
    """Cut a cell (``manifest.cell``'s dict) to the tiny sizes, in place."""
    cfg = cell["config"]
    cfg["text"].update(TEXT)
    cfg["vision"].update(VISION)
    cfg["projector"].update(PROJECTOR)
    cfg["lora"]["rank"] = 4
    cfg["freeze_text_layers"] = [0]
    cfg.update(num_vis_tokens=16, num_views=2, image_size=42, max_length=64, batch_size_per_gpu=2, grad_accum=2)
    spec = cell["spec"]
    spec["rows"] = 2
    if spec["driver"] == "qa":
        spec.update(batch=2, max_new_tokens=4, checked=2)
