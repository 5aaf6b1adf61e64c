"""Training of the PyTorch port: so far only the half of LoRA that serving
uses (train/lora.py). The trainers are not ported (ROADMAP.md queue A item
15)."""

from .lora import (  # noqa: F401
    AdapterLoadError,
    LoraConfig,
    LoraTrainer,
    load_adapters,
    merge_lora,
    save_adapters,
)
