from osufusion_tpu_torch.serve.generate import LENGTH_BUCKET, generate_beatmap, load_model

__all__ = ["LENGTH_BUCKET", "generate_beatmap", "load_model"]
