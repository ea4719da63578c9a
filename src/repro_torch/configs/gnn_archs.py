"""The four assigned GNN architecture configs + reduced smoke variants."""
from repro_torch.config import GNNConfig


def equiformer_v2() -> GNNConfig:
    # [arXiv:2306.12059] 12L d128 l_max 6 m_max 2 8 heads, SO(2)-eSCN
    return GNNConfig(name="equiformer-v2", model="equiformer_v2", n_layers=12,
                     d_hidden=128,
                     extra={"l_max": 6, "m_max": 2, "n_heads": 8})


def equiformer_v2_reduced() -> GNNConfig:
    return GNNConfig(name="equiformer-v2-reduced", model="equiformer_v2",
                     n_layers=2, d_hidden=16,
                     extra={"l_max": 2, "n_heads": 2})


def nequip() -> GNNConfig:
    # [arXiv:2101.03164] 5L hidden 32 l_max 2 n_rbf 8 cutoff 5
    return GNNConfig(name="nequip", model="nequip", n_layers=5, d_hidden=32,
                     extra={"l_max": 2, "n_rbf": 8, "cutoff": 5.0})


def nequip_reduced() -> GNNConfig:
    return GNNConfig(name="nequip-reduced", model="nequip", n_layers=2,
                     d_hidden=8, extra={"l_max": 1, "n_rbf": 4, "cutoff": 5.0})


def gatedgcn() -> GNNConfig:
    # [arXiv:2003.00982] 16L d70 gated aggregator
    return GNNConfig(name="gatedgcn", model="gatedgcn", n_layers=16,
                     d_hidden=70, extra={"n_classes": 16})


def gatedgcn_reduced() -> GNNConfig:
    return GNNConfig(name="gatedgcn-reduced", model="gatedgcn", n_layers=2,
                     d_hidden=16, extra={"n_classes": 4})


def dimenet() -> GNNConfig:
    # [arXiv:2003.03123] 6 blocks d128 n_bilinear 8 n_spherical 7 n_radial 6
    return GNNConfig(name="dimenet", model="dimenet", n_layers=6, d_hidden=128,
                     extra={"n_bilinear": 8, "n_spherical": 7, "n_radial": 6,
                            "cutoff": 5.0})


def dimenet_reduced() -> GNNConfig:
    return GNNConfig(name="dimenet-reduced", model="dimenet", n_layers=2,
                     d_hidden=16,
                     extra={"n_bilinear": 4, "n_spherical": 3, "n_radial": 4,
                            "cutoff": 5.0})
