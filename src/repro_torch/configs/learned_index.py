"""The paper's own index configurations (Fig 4-6 grid).

Not an LM arch: these are the RMI configurations the paper grid-searches
(§3.6) plus the B-Tree page sizes it compares against.  Used by the
benchmark harness and the index-service example.
"""

from repro_torch.core.rmi import RMIConfig

# second-stage sizes from Fig 4-6
RMI_GRID = {
    "rmi-10k": RMIConfig(num_leaves=10_000, stage0_hidden=()),
    "rmi-50k": RMIConfig(num_leaves=50_000, stage0_hidden=()),
    "rmi-100k": RMIConfig(num_leaves=100_000, stage0_hidden=()),
    "rmi-200k": RMIConfig(num_leaves=200_000, stage0_hidden=()),
    # "Learned Index Complex": 2 hidden layers, 16 wide (Fig 4-6 last rows)
    "rmi-100k-complex": RMIConfig(num_leaves=100_000, stage0_hidden=(16, 16)),
}

BTREE_PAGE_SIZES = (16, 32, 64, 128, 256)
