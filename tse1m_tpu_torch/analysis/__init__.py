"""The paper's research-question drivers over ``TorchBackend``."""
