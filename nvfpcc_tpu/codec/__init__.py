"""Encode/decode orchestration + pack container (reference ``NVFPCC.py``
encode/decode subcommands) and the weight quantize/pack pipeline
(``manipulate_weights.py`` + ``util_code_quantized_weights.py``)."""

from nvfpcc_tpu.codec.codec import (  # noqa: F401
    PACK_FORMAT_VERSION,
    EncodeResult,
    decode,
    decode_inputs,
    decode_origins,
    encode,
    encode_origins,
    extract_points,
    load_pack,
    reconstruct_all,
    reconstruct_points,
    save_pack,
)
from nvfpcc_tpu.codec.weights import (  # noqa: F401
    check_quantized,
    pack_weights,
    quantize_residuals,
    unpack_weights,
    weight_pack_bits,
)
