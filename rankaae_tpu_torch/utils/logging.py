"""File loggers (counterpart of ``rankaae_tpu/utils/logging.py``): the
per-trial ``messages.txt`` event log and ``losses.csv``, the 12-column loss
table, exact schema of the reference's ``trainer.py:84-87``, consumed
unmodified by the report layer's LossCurvePlotter."""
from __future__ import annotations

import logging
import os


def create_logger(name: str, file_path: str, append: bool = False) -> logging.Logger:
    """A logger named ``name`` writing to ``file_path`` alone (reference
    ``sc/utils/logger.py``)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logger.propagate = False
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    fh = logging.FileHandler(file_path, mode="a" if append else "w")
    fh.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.addHandler(fh)
    return logger


LOSS_CSV_HEADER = (
    "Epoch,Train_D,Val_D,Train_G,Val_G,Train_Aux,Val_Aux,Train_Recon,"
    "Val_Recon,Train_Smooth,Val_Smooth,Train_Mutual_Info,Val_Mutual_Info"
)


def format_loss_row(epoch: int, logs_at_epoch: dict) -> str:
    """One losses.csv row, byte-format-compatible with the reference's
    ``trainer.py:270-279`` (tab after every comma, trailing ',\\t', 6 decimal
    places)."""
    g = logs_at_epoch
    vals = [
        g["train_dis"], g["val_dis"],
        g["train_gen"], g["val_gen"],
        g["train_aux"], g["val_aux"],
        g["train_recon"], g["val_recon"],
        g["train_smooth"], g["val_smooth"],
        g["train_mi"], g["val_mi"],
    ]
    return f"{epoch:d},\t" + ",\t".join(f"{float(v):.6f}" for v in vals) + ",\t"


def append_losses_csv(path: str, logs: dict, epoch_offset: int, every: int = 10) -> None:
    """Append the rows of a log segment that covers the absolute epochs
    [epoch_offset, epoch_offset + len): the incremental form of
    :func:`write_losses_csv` that segmented runs use
    (``rankaae_tpu/utils/logging.py:51``).  The header is written with the
    first segment."""
    new_file = not os.path.exists(path)
    with open(path, "a") as f:
        if new_file:
            f.write(LOSS_CSV_HEADER + "\n")
        for i in range(len(logs["epoch"])):
            epoch = epoch_offset + i
            if epoch % every == 0:
                row = {k: v[i] for k, v in logs.items() if k != "metrics"}
                f.write(format_loss_row(epoch, row) + "\n")


def write_losses_csv(path: str, logs: dict, every: int = 10) -> None:
    """Dump the loss table for epochs where ``epoch % every == 0``
    (the reference logs every 10 epochs, ``trainer.py:270``).  ``logs`` maps
    each key to a per-epoch sequence of host numbers."""
    n_epochs = len(logs["epoch"])
    with open(path, "w") as f:
        f.write(LOSS_CSV_HEADER + "\n")
        for e in range(n_epochs):
            if e % every == 0:
                row = {k: v[e] for k, v in logs.items() if k != "metrics"}
                f.write(format_loss_row(e, row) + "\n")
