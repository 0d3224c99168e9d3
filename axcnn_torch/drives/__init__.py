"""The convergence drives: the port's counterparts of the reference's
``scripts/convergence_drive.py``, ``convergence_drive_full.py``,
``ablation_drive.py``, ``kd_drive.py``, ``convergence_drive_scale.py``,
``finetune_drive.py``, ``convergence_drive_1k.py``, ``bl_drive.py``,
``int8_serving_drive.py`` and ``acceptance_drive.py``, each trained (or
served) at full width and checked against the reference's bars, and of its
KD diagnostics, ``kd_probe.py`` and ``kd_sweep.py``.

    python -m axcnn_torch.drives.convergence        # config 4, 300 steps
    python -m axcnn_torch.drives.convergence_full   # production constants, warm start
    python -m axcnn_torch.drives.ablation           # assembled vs vanilla, relative mCE
    python -m axcnn_torch.drives.kd                 # config 5 through the training CLI
    python -m axcnn_torch.drives.convergence_scale  # 50 classes, echo 2
    python -m axcnn_torch.drives.finetune           # the warm start through run()
    python -m axcnn_torch.drives.convergence_1k     # the 1001-way head through the CLI
    python -m axcnn_torch.drives.bl                 # Big-Little against its ablation
    python -m axcnn_torch.drives.int8_serving       # int8 against bf16, a trained model
    python -m axcnn_torch.drives.acceptance         # the five BASELINE configs, the recipes
    python -m axcnn_torch.drives.kd_probe           # the KD teacher's health (after kd)
    python -m axcnn_torch.drives.kd_sweep           # the LR behind kd's 0.1 (after kd)

Each takes the reference script's positional arguments and defaults, runs
on the CUDA card unless given ``--cpu``, reads generated JPEG shards
(``axcnn_torch.drives.data``) through the native loader only, ends with one
JSON summary line and, when its ``check`` holds, its OK line; a missed bar
raises ``AssertionError`` with the summary (``kd_sweep`` has no bars).
"""
