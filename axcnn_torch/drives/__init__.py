"""The convergence drives: the port's counterparts of the reference's
``scripts/convergence_drive.py``, ``convergence_drive_full.py``,
``ablation_drive.py`` and ``kd_drive.py``, each trained to a held-out top-1
at full width and checked against the reference's bars.

    python -m axcnn_torch.drives.convergence        # config 4, 300 steps
    python -m axcnn_torch.drives.convergence_full   # production constants, warm start
    python -m axcnn_torch.drives.ablation           # assembled vs vanilla, relative mCE
    python -m axcnn_torch.drives.kd                 # config 5 through the training CLI

Each takes the reference script's positional arguments and defaults, runs
on the CUDA card unless given ``--cpu``, reads generated JPEG shards
(``axcnn_torch.drives.data``) through the native loader only, ends with one
JSON summary line and, when its ``check`` holds, its OK line; a missed bar
raises ``AssertionError`` with the summary.
"""
