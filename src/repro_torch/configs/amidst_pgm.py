"""The paper's own PGM workloads (copied from ``repro.configs.amidst_pgm``
with their widths unchanged).  They mirror the models of the AMIDST/d-VMP
evaluations: large Gaussian-mixture / NB-with-latent plates whose local
node count (instances x latent+leaf nodes) reaches the >1e9 scale."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.dag import PlateSpec


@dataclasses.dataclass(frozen=True)
class PGMWorkload:
    name: str
    spec: PlateSpec
    description: str

    def nodes_per_instance(self) -> int:
        """Local graph nodes per instance (latents + leaves)."""
        n = self.spec.n_features
        if self.spec.latent_card:
            n += 1
        return n + self.spec.latent_dim


PGM_WORKLOADS: Dict[str, PGMWorkload] = {
    "gmm_large": PGMWorkload(
        name="gmm_large",
        spec=PlateSpec(n_features=10, latent_card=4),
        description="10-feature 4-component GMM: 11 local nodes/instance; "
                    "1e8 instances = 1.1e9 nodes (the d-VMP scale claim)",
    ),
    "nb_mixed": PGMWorkload(
        name="nb_mixed",
        spec=PlateSpec(n_features=12, latent_card=3,
                       discrete_features=((10, 4), (11, 4))),
        description="mixed continuous/discrete NB with latent class "
                    "(financial-sector style, paper refs [1,2])",
    ),
    "fa_plate": PGMWorkload(
        name="fa_plate",
        spec=PlateSpec(n_features=16, latent_card=0, latent_dim=4),
        description="factor-analysis plate: 4 local continuous latents",
    ),
}
