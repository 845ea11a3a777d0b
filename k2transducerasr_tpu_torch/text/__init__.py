from k2transducerasr_tpu_torch.text.symbol_table import SymbolTable
from k2transducerasr_tpu_torch.text.bytebpe import byte_encode, byte_decode, smart_byte_decode
from k2transducerasr_tpu_torch.text.hotwords import apply_hotwords, boost_tokens
from k2transducerasr_tpu_torch.text.postprocess import tokens_to_text

__all__ = [
    "SymbolTable",
    "apply_hotwords",
    "boost_tokens",
    "byte_encode",
    "byte_decode",
    "smart_byte_decode",
    "tokens_to_text",
]
