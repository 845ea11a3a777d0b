from k2transducerasr_tpu_torch.text.symbol_table import SymbolTable
from k2transducerasr_tpu_torch.text.bytebpe import byte_encode, byte_decode, smart_byte_decode
from k2transducerasr_tpu_torch.text.postprocess import tokens_to_text

__all__ = [
    "SymbolTable",
    "byte_encode",
    "byte_decode",
    "smart_byte_decode",
    "tokens_to_text",
]
