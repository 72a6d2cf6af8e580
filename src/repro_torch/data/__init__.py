from repro_torch.data.datasets import (
    gen_lognormal,
    gen_maps,
    gen_urls,
    gen_weblogs,
    gen_webdocs,
)

__all__ = ["gen_lognormal", "gen_maps", "gen_urls", "gen_weblogs", "gen_webdocs"]
