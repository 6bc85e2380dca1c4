"""Model configuration: ``BertConfig``.

A copy of the JAX package's ``config.BertConfig`` (same defaults, the same
dict/JSON constructors with merge semantics, ``head_dim`` and
``padded_vocab_size``), kept here so the port imports nothing of that
package. Behavioral parity target: reference src/modeling.py:188-295.
"""

from __future__ import annotations

import copy
import json
from typing import Any


class BertConfig:
    """Architecture configuration for the BERT model family.

    Mirrors reference src/modeling.py:188-295 (``BertConfig``): the same
    default values, dict/JSON constructors with merge semantics, and tolerance
    for extra keys (the reference stores tokenizer/data keys in the same file,
    run_pretraining.py:369-374).
    """

    def __init__(
        self,
        vocab_size: int = 30522,
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: int = 3072,
        hidden_act: str = "gelu",
        hidden_dropout_prob: float = 0.1,
        attention_probs_dropout_prob: float = 0.1,
        max_position_embeddings: int = 512,
        type_vocab_size: int = 2,
        initializer_range: float = 0.02,
        layer_norm_eps: float = 1e-12,
        next_sentence: bool = True,
        output_all_encoded_layers: bool = False,
        pad_token_id: int = 0,
        **extra: Any,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.next_sentence = next_sentence
        self.output_all_encoded_layers = output_all_encoded_layers
        self.pad_token_id = pad_token_id
        # Extra keys (vocab_file, tokenizer, lowercase, ...) ride along so the
        # data path can read them from the same file.
        for key, value in extra.items():
            setattr(self, key, value)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_dict(cls, json_object: dict) -> "BertConfig":
        """Construct from a dict, merging onto defaults (modeling.py:255-261)."""
        config = cls()
        for key, value in json_object.items():
            setattr(config, key, value)
        return config

    @classmethod
    def from_json_file(cls, json_file: str) -> "BertConfig":
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return copy.deepcopy(self.__dict__)

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def to_json_file(self, json_file: str) -> None:
        with open(json_file, "w", encoding="utf-8") as writer:
            writer.write(self.to_json_string())

    def __repr__(self) -> str:
        return f"BertConfig {self.to_json_string()}"

    # -- derived properties --------------------------------------------------

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} is not a multiple of "
                f"num_attention_heads {self.num_attention_heads}"
            )
        return self.hidden_size // self.num_attention_heads

    def padded_vocab_size(self, multiple: int = 8) -> int:
        """Vocab padded up for MXU-friendly tiling (run_pretraining.py:237-238
        pads to a multiple of 8; on TPU 128-lane alignment is natural but 8
        keeps checkpoint-shape parity)."""
        return ((self.vocab_size + multiple - 1) // multiple) * multiple
