"""The recipes: the reference's wrapper scripts (``scripts/*.sh``) as one
table, each run through the training CLI in this process.

    python -m axcnn_torch.cli.recipes <recipe> <positionals...> [flags...]

    python -m axcnn_torch.cli.recipes train_assemble_from_scratch DATA_DIR MODEL_DIR
    python -m axcnn_torch.cli.recipes eval DATA_DIR MODEL_DIR --train.use_ema
    python -m axcnn_torch.cli.recipes train_vanilla_from_scratch DATA_DIR MODEL_DIR
    python -m axcnn_torch.cli.recipes train_assemble_resnet152_kd DATA_DIR MODEL_DIR TEACHER_CKPT_DIR
    python -m axcnn_torch.cli.recipes finetune_fgvc DATASET DATA_DIR MODEL_DIR PRETRAINED_CKPT_DIR
    python -m axcnn_torch.cli.recipes eval_imagenet_c IMAGENET_C_DIR MODEL_DIR

Each recipe writes its preset's ``--config=``, its positionals as the flags
its script writes, in the same order, and its fixed flags
(``--runtime.eval_only``, ``--runtime.eval_imagenet_c``), then passes the
rest through unchanged (the CLI takes a flag's last occurrence, so a flag
passed through overrides the recipe's). The command is ``axcnn_torch.cli.main_classification.main`` called in this
process, with the argv its script hands ``python -m
axcnn.cli.main_classification``. A missing or empty positional exits 1 with
a usage line that names them, as the scripts' ``${N:?usage: ...}`` do.
"""

from __future__ import annotations

import sys

# name: (preset, [(positional, the flag it becomes)], fixed flags after them)
RECIPES = {
    "train_assemble_from_scratch": (
        "assemble_resnet50",
        [("DATA_DIR", "--data.data_dir"), ("MODEL_DIR", "--runtime.model_dir")], []),
    "eval": (
        "assemble_resnet50",
        [("DATA_DIR", "--data.data_dir"), ("MODEL_DIR", "--runtime.model_dir")],
        ["--runtime.eval_only"]),
    "train_vanilla_from_scratch": (
        "vanilla_resnet50",
        [("DATA_DIR", "--data.data_dir"), ("MODEL_DIR", "--runtime.model_dir")], []),
    "train_assemble_resnet152_kd": (
        "assemble_resnet152_kd",
        [("DATA_DIR", "--data.data_dir"), ("MODEL_DIR", "--runtime.model_dir"),
         ("TEACHER_CKPT_DIR", "--train.kd_teacher_checkpoint")], []),
    "finetune_fgvc": (
        "finetune_fgvc",
        [("DATASET", "--data.dataset_name"), ("DATA_DIR", "--data.data_dir"),
         ("MODEL_DIR", "--runtime.model_dir"),
         ("PRETRAINED_CKPT_DIR", "--train.pretrained_checkpoint")], []),
    "eval_imagenet_c": (
        "assemble_resnet50",
        [("IMAGENET_C_DIR", "--data.data_dir"), ("MODEL_DIR", "--runtime.model_dir")],
        ["--runtime.eval_imagenet_c"]),
}


def usage(name: str) -> str:
    _, positionals, _ = RECIPES[name]
    extra = " [--train.use_ema]" if name == "eval" else ""
    return f"usage: {name} {' '.join(p for p, _ in positionals)}{extra}"


def recipe_argv(name: str, args) -> list:
    """The training CLI's argv for recipe ``name`` on ``args`` (its
    positionals, then flags passed through). ``SystemExit(1)`` after the
    usage line on stderr when a positional is missing or empty."""
    preset, positionals, fixed = RECIPES[name]
    args = list(args)
    if len(args) < len(positionals) or not all(args[:len(positionals)]):
        print(usage(name), file=sys.stderr)
        raise SystemExit(1)
    flags = [f"{flag}={value}" for (_, flag), value in zip(positionals, args)]
    return [f"--config={preset}", *flags, *fixed, *args[len(positionals):]]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in RECIPES:
        print("usage: python -m axcnn_torch.cli.recipes RECIPE ARGS... [FLAGS...]\n"
              "recipes:\n" + "\n".join(f"  {usage(n)}" for n in RECIPES), file=sys.stderr)
        raise SystemExit(1)
    from axcnn_torch.cli import main_classification

    return main_classification.main(recipe_argv(argv[0], argv[1:]))


if __name__ == "__main__":
    main()
