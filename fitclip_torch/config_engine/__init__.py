from fitclip_torch.config_engine.compose import compose, expand_multirun
from fitclip_torch.config_engine.instantiate import instantiate

__all__ = ["compose", "expand_multirun", "instantiate"]
