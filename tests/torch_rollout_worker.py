"""A fleet controller process of its own for tests/test_torch_fleet.py.

Holds no endpoint roster: ``ModelFleet.from_seeds`` on the one seed in argv,
then a rollout of ``<model>`` to the arrays of ``<npz>`` (version
``<version>``), as a controller on a fresh operator host would. With
``SRML_TORCH_FAULT_PLAN=fleet.rollout:crash:...`` in its env it dies at the
chosen rollout phase (exit 17), after that phase's intent was gossiped.
Prints ``DONE <json>`` when the plan lets it live. Imports only the port.

    python tests/torch_rollout_worker.py <seed> <npz> <model> <version>
"""

import json
import sys


def main() -> None:
    import numpy as np

    from spark_rapids_ml_tpu_torch.serve.fleet import ModelFleet

    seed, npz_path, model, version = sys.argv[1:5]
    arrays = dict(np.load(npz_path))
    with ModelFleet.from_seeds([seed]) as fleet:
        res = fleet.rollout(model, "pca", arrays, version=int(version), warm=False)
    print("DONE " + json.dumps({k: res[k] for k in ("version", "previous", "drained")}),
          flush=True)


if __name__ == "__main__":
    main()
