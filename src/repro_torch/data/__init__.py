from repro_torch.data.corpus import (ByteTokenizer, calibration_slices,
                                     generate_corpus, token_stream)
from repro_torch.data.pretrained import corpus_tokens

__all__ = ["ByteTokenizer", "generate_corpus", "token_stream",
           "calibration_slices", "corpus_tokens"]
