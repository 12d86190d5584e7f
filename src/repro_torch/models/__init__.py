"""The model scaffold on one card: configs, parameter specs, layers, GQA
attention, the dense FFN and the backbone (families ``dense`` and ``vlm``
so far; ROADMAP Queue A item 15)."""
