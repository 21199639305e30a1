"""One rank of ``tests/test_torch_multihost.py``'s process groups (not a
test module): ``python tests/torch_multihost_worker.py SCENARIO DIR
[COORDINATOR RANK]``.  It joins a 2-process gloo group (from the
arguments, or from torchrun's environment when only SCENARIO and DIR are
given), runs SCENARIO on the CPU with the inputs the test wrote into DIR,
and pickles what it got to ``DIR/rank_<r>.pkl``."""
import json
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rankaae_tpu_torch.parallel import multihost  # noqa: E402
from rankaae_tpu_torch.parallel.trials import RowShards, run_trials  # noqa: E402
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData  # noqa: E402
from rankaae_tpu_torch.utils.config import TrainConfig  # noqa: E402

torch.set_num_threads(1)
NU0 = 1e-8


def _from_nu0():
    """Every init_state starts from second moments of NU0, as the trial
    tests' runs do (``tests/torch_parity.py``)."""
    init = RankAAETrainer.init_state

    def init_state(self, *args, **kw):
        state = init(self, *args, **kw)
        for o in state.opt.values():
            for v in o.nu:
                v.fill_(NU0)
        return state

    RankAAETrainer.init_state = init_state


def main():
    scenario, work = sys.argv[1], sys.argv[2]
    if len(sys.argv) > 3:
        multihost.initialize(sys.argv[3], 2, int(sys.argv[4]))
    else:
        multihost.initialize()
    rank, world = multihost.world()
    out = {"world": (rank, world), "gathered": multihost.all_gather_objects(rank * 10),
           "device": str(multihost.rank_device("cpu"))}
    try:
        multihost.rank_device()
    except RuntimeError as e:          # no card here: cuda:<local rank> is absent
        out["no_card"] = str(e)
    if scenario != "init":
        with open(os.path.join(work, "run.json")) as f:
            run = json.load(f)
        with np.load(os.path.join(work, "data.npz")) as z:
            data = TrialData(*(torch.from_numpy(z[k]) for k in
                               ("train_spec", "train_aux", "val_spec", "val_aux")))
        cfg = TrainConfig(**run["cfg"])
        _from_nu0()
        gathers = out["row_gathers"] = []
        real = RowShards.gather

        def gather(self, flat):
            gathers.append(self.per)
            return real(self, flat)

        RowShards.gather = gather
        results = []
        for epochs, resume in run["runs"]:
            try:
                results.append(run_trials(cfg.replace(max_epoch=epochs), data,
                                          n_trials=run["n_trials"], seed=run["seed"],
                                          device="cpu", dp=run.get("dp", 1),
                                          checkpoint_dir=resume))
            except ValueError as e:
                results.append(str(e))
        out["results"] = results
    with open(os.path.join(work, f"rank_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
