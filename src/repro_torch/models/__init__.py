"""The model scaffold on one card: configs, parameter specs, layers, GQA and
sliding-window attention, the dense FFN, the RG-LRU and Mamba-2 (SSD)
blocks and the backbone (families ``dense``, ``vlm``, ``hybrid`` and
``ssm`` so far; ROADMAP Queue A item 15)."""
