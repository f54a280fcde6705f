from repro_torch.nn.init import param, truncated_normal

__all__ = ["param", "truncated_normal"]
