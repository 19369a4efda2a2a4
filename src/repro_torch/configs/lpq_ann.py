"""The paper's own evaluation configs: HNSW/FAISS-flat/NGT-equivalent
indexes over PRODUCT-style, SIFT-like and GloVe-like corpora, fp32 vs
int8 arms, HNSW hyperparameter grid from §5.2 (EFC 300..700, M {32,48},
EFS 300..800).
Port of ``repro.configs.lpq_ann``."""

import dataclasses

ARCH_ID = "lpq-ann"
FAMILY = "ann"
SKIP = {}


@dataclasses.dataclass(frozen=True)
class ANNConfig:
    dataset: str = "product"        # product | sift | glove
    n: int = 60_000_000             # PRODUCT60M scale (reduced in benches)
    n_queries: int = 1000
    k: int = 100                    # paper fixes k=100
    bits: int = 8
    scheme: str = "gaussian"
    sigmas: float = 3.0             # clamp width (paper: 1.0; see EXPERIMENTS)
    # unified-API factory string (the paper's primary arm); benchmarks and
    # the serving loop build through repro_torch.knn.make_index(index)
    index: str = "hnsw32,lpq8@gaussian:3"
    # HNSW grid (paper §5.2)
    m_grid: tuple = (32, 48)
    efc_grid: tuple = (300, 400, 600, 700)
    efs_grid: tuple = (300, 400, 500, 600, 700, 800)

    def index_spec(self):
        """Parsed IndexSpec for the configured factory string (lazy imports:
        configs stay importable without the index modules)."""
        from repro_torch.data.synthetic import METRIC_FOR
        from repro_torch.knn.spec import parse_factory

        return parse_factory(self.index, metric=METRIC_FOR[self.dataset])


def config() -> ANNConfig:
    return ANNConfig()


def reduced_config() -> ANNConfig:
    return ANNConfig(
        n=4000, n_queries=32, k=10, index="hnsw8,lpq8@gaussian:3",
        m_grid=(8,), efc_grid=(40,), efs_grid=(40, 80),
    )


SHAPES = {
    "product60m": dict(kind="ann", dataset="product", metric="ip"),
    "sift1m": dict(kind="ann", dataset="sift", metric="l2"),
    "glove100": dict(kind="ann", dataset="glove", metric="angular"),
}
