from repro_torch.data.datasets import gen_lognormal, gen_maps

__all__ = ["gen_lognormal", "gen_maps"]
