"""The port's measuring and operator tools, each runnable as

    python -m openbts_ttsou_tpu_torch.tools.<name> [--device cuda|cpu] ...

Every tool is a module with `main(argv=None) -> dict`: it prints its
record as one JSON object on the last line of standard output and
returns it. A tool runs on `cuda` unless given `--device cpu`, and
raises without a card otherwise. What a tool writes goes under
`build/tools/` of the checkout unless `--out` names another path.
"""
