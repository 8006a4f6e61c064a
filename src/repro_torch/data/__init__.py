from repro_torch.data.corpus import ByteTokenizer

__all__ = ["ByteTokenizer"]
