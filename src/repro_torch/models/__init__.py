"""The model scaffold: configs, parameter specs (and a rank's shards of
them), layers with the collectives across ranks, GQA, sliding-window and
MLA attention, the dense FFN and MoE, the RG-LRU and Mamba-2 (SSD) blocks
and the backbone: every family on one rank and across ranks (ROADMAP
Queue A item 15 sub-items 6a-6c)."""
