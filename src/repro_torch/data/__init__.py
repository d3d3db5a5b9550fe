from repro_torch.data.synthetic import DataIterator, make_batch

__all__ = ["DataIterator", "make_batch"]
