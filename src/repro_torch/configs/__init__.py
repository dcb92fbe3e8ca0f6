"""Assigned architecture configs (exact public dims) + smoke variants."""
from __future__ import annotations

import importlib

ARCHS = (
    "phi4_mini_3_8b", "nemotron_4_15b", "gemma2_27b", "h2o_danube_3_4b",
    "granite_moe_1b_a400m", "qwen2_moe_a2_7b", "recurrentgemma_2b",
    "seamless_m4t_large_v2", "internvl2_1b", "xlstm_1_3b",
)

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get(name: str, smoke: bool = False):
    mod_name = name.replace("-", "_").replace(".", "_")
    mod_name = ALIASES.get(mod_name, mod_name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()


def all_archs():
    return list(ARCHS)
