"""Writes tests/data/w1_tokenizer.json, the byte-level BPE tokenizer (4,096
tokens) that chip_smoke.py's W1 path and tests/test_torch_tokenizer_file.py
read: trained with the ``tokenizers`` package on texts drawn the way W1
draws its payloads (chip_smoke.py ``crawl_vocabulary``, ``crawl_texts``), from a
seed of their own.

    python tests/data/make_w1_tokenizer.py
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

VOCAB_SIZE = 4096
TEXTS = 3000
SEED = 4096


def main() -> None:
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors, trainers

    import chip_smoke as cs

    texts = cs.crawl_texts(np.random.default_rng(SEED), TEXTS, cs.crawl_vocabulary())
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=True)
    trainer = trainers.BpeTrainer(vocab_size=VOCAB_SIZE, special_tokens=["<|endoftext|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(texts, trainer)
    tok.save(os.path.join(HERE, "w1_tokenizer.json"))
    print(f"w1_tokenizer.json: {tok.get_vocab_size()} tokens")


if __name__ == "__main__":
    main()
