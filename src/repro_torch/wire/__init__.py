"""Byte-exact wire codec of the tree front end's ``MSG_TREE`` exchange
(DESIGN.md §9, §15).

Pure numpy, carried over unchanged from the reference package's ``wire`` so
that both packages frame the tree's per-level digest and verdict messages
byte for byte alike; ``repro_torch.tree`` uses it for its verdict codes and
its framed byte ledger.  Tree bytes are transport overhead, split from PBS
ledger bits.  The codecs of the other protocol messages come over with the
endpoint port that uses them.
"""
from .frames import (
    MSG_TREE,
    TREE_DIGEST,
    TREE_LEAF,
    TREE_PRUNE,
    TREE_RECURSE,
    TREE_VERDICT,
    decode_tree_digest,
    decode_tree_verdict,
    encode_tree_digest,
    encode_tree_verdict,
    frame,
)
from .varint import WireError, WireTruncated, decode_uvarint, encode_uvarint, uvarint_len

__all__ = [
    "MSG_TREE",
    "TREE_DIGEST",
    "TREE_LEAF",
    "TREE_PRUNE",
    "TREE_RECURSE",
    "TREE_VERDICT",
    "WireError",
    "WireTruncated",
    "decode_tree_digest",
    "decode_tree_verdict",
    "decode_uvarint",
    "encode_tree_digest",
    "encode_tree_verdict",
    "encode_uvarint",
    "frame",
    "uvarint_len",
]
