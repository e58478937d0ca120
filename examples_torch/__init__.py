"""PyTorch twins of the scripts under ``examples/``, on the port
``gptorch_tpu_torch``.

Each twin keeps its JAX script's arguments, data and printed lines, adds
``--device`` (``cuda`` by default; with no card present the script raises
unless given ``--device cpu``) and returns its summary numbers from
``main(argv)`` as a dict.
"""
