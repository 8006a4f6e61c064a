from repro_torch.data.corpus import (ByteTokenizer, batches,
                                     calibration_slices, eval_batches,
                                     generate_corpus, token_stream)
from repro_torch.data.pretrained import corpus_tokens

__all__ = ["ByteTokenizer", "generate_corpus", "token_stream",
           "calibration_slices", "batches", "eval_batches",
           "corpus_tokens"]
