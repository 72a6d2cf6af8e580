from repro_torch.data.datasets import gen_lognormal, gen_maps, gen_weblogs

__all__ = ["gen_lognormal", "gen_maps", "gen_weblogs"]
