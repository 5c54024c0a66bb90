from polydeal_tpu_torch.utils.grouping import padded_group_lists

__all__ = ["padded_group_lists"]
