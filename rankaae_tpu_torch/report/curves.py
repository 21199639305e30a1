"""The evaluator classes and the loss-curve plot (counterpart of
``rankaae_tpu/report/curves.py``; reference ``sc/report/analysis_new.py``).

``Evaluator`` is the serialisable base (``as_dict``/``from_dict``),
``EvaluatorAll`` scores one bundle against a dataset, ``Reporter`` ranks
every ``job_*`` of a training directory, ``Reconstruct`` writes a model's
inputs, styles and reconstructions as text, ``LossCurvePlotter`` draws
``losses.csv`` and ``SpectraVariationEvaluator`` wraps the decoder sweep.
Models are the port's :class:`InferenceModel` on ``device`` (default
``"cuda"``); matplotlib is imported only to draw.
"""
from __future__ import annotations

import os
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.report import analysis


class Evaluator:
    """Base of the model-property evaluators (reference
    ``analysis_new.py:55-92``): a ``result`` payload and its provenance
    ``metadata``; subclasses implement ``evaluate`` and ``plot``."""

    def __init__(self, name: Optional[str] = None):
        self.result: Dict = {}
        self.metadata: Dict = {}
        self.name = name

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError

    def plot(self, ax=None):
        raise NotImplementedError

    def _process_metadata(self, data_path=None, model_path=None):
        dt = datetime.now(timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
        self.metadata.update({"name": self.name, "datetime": f"{dt} UTC",
                              "data": data_path, "model": model_path})

    def as_dict(self) -> Dict:
        return {
            "@class": type(self).__name__,
            "name": self.name,
            "metadata": dict(self.metadata),
            "result": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in (self.result.items()
                                    if isinstance(self.result, dict) else [])},
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Evaluator":
        obj = cls.__new__(cls)
        Evaluator.__init__(obj, name=d.get("name"))
        obj.metadata = dict(d.get("metadata", {}))
        obj.result = {k: (np.asarray(v) if isinstance(v, list) else v)
                      for k, v in d.get("result", {}).items()}
        return obj


class EvaluatorAll(Evaluator):
    """One bundle's full scores against one split of a dataset
    (:func:`analysis.evaluate_model`)."""

    def __init__(self, name: str = "model_evaluation", device=None):
        super().__init__(name=name)
        self.device = device
        self.data = None
        self.model: Optional[InferenceModel] = None

    @classmethod
    def from_file(cls, data_path: str, model_path: str, n_aux: int = 5,
                  split_portion: str = "val", device=None) -> "EvaluatorAll":
        obj = cls(device=device)
        obj.load_data(data_path, n_aux=n_aux, split_portion=split_portion)
        obj.load_model(model_path)
        return obj

    def load_model(self, model_path: str):
        self.model = InferenceModel.from_bundle(model_path, device=self.device)
        self.metadata["model"] = model_path

    def load_data(self, data_path: str, n_aux: int = 5, split_portion: str = "val"):
        from rankaae_tpu_torch.data.dataset import AuxSpectraDataset

        self.data = AuxSpectraDataset(data_path, split_portion=split_portion, n_aux=n_aux)
        self.metadata["data"] = data_path

    def evaluate(self) -> Dict:
        assert self.model is not None and self.data is not None
        self._process_metadata(self.metadata.get("data"), self.metadata.get("model"))
        self.result = analysis.evaluate_model(self.data, self.model)
        return self.result


class Reporter:
    """The evaluations of every ``job_*`` of a training directory, ranked by
    the report's scoring rule."""

    def __init__(self, device=None):
        self.device = device
        self.evaluations: Dict[str, Dict] = {}
        self.ranked_jobs: List[str] = []

    def add_evaluations(self, evaluation_list):
        for ev in evaluation_list:
            job = ev.metadata.get("model")
            if job is None:
                # evaluators with no model path (Reconstruct) each get a key
                key = f"evaluation_{len(self.evaluations) + 1}"
            else:
                key = os.path.basename(os.path.dirname(str(job))) or str(job)
            self.evaluations[key] = ev.result

    def evaluate_all_models(self, training_path: str = "./training", test_ds=None):
        assert test_ds is not None, "pass the evaluation dataset"
        self.evaluations = analysis.evaluate_all_models(training_path, test_ds,
                                                        device=self.device)
        return self.evaluations

    def load_evaluations(self, evaluation_path="./report_model_evaluations.pkl"):
        self.evaluations = analysis.load_evaluations(evaluation_path)
        return self.evaluations

    def report(self, plot: bool = False, top_n: Optional[int] = None):
        """Rank the evaluations; returns (summary dataframe, fig or None)."""
        from rankaae_tpu_torch.report.generate_report import sorting_algorithm

        results, ranked, fig = analysis.sort_all_models(
            self.evaluations, sort_score=sorting_algorithm, ascending=False,
            plot_score=plot, top_n=top_n)
        self.ranked_jobs = list(ranked)
        rows = [{"job": job, "Rank": results[job]["Rank"], "Score": results[job]["Score"],
                 "Recon Err": results[job]["Reconstruct Err"][0]} for job in ranked]
        return pd.DataFrame(rows), fig


class Reconstruct(Evaluator):
    """A model's inputs, styles and reconstructions of a dataset, written
    as ``<name>_spec_in/_spec_out/_styles.txt`` (reference
    ``analysis_new.py:94-129``)."""

    def __init__(self, name: str = "reconstructed"):
        super().__init__(name=name)

    def evaluate(self, test_ds, model: InferenceModel, path_to_save=None):
        self._process_metadata(data_path=test_ds.metadata["path"])
        spec_in = np.asarray(test_ds.spec, np.float32)
        styles = model.encode(spec_in)
        self.result.update({"input": spec_in, "styles": styles, "output": model.decode(styles)})
        if path_to_save is not None:
            self.to_file(path_to_save)

    def to_file(self, path_to_save):
        base = os.path.join(path_to_save, self.name)
        np.savetxt(base + "_spec_in.txt", self.result["input"])
        np.savetxt(base + "_spec_out.txt", self.result["output"])
        np.savetxt(base + "_styles.txt", self.result["styles"])


class LossCurvePlotter:
    """Six stacked train/val loss plots from a ``losses.csv`` (reference
    ``analysis_new.py:246-280``)."""

    def __init__(self):
        self.loss_names = ["D", "G", "Aux", "Recon", "Smooth", "Mutual_Info"]
        self.loss_dict = {name: {} for name in self.loss_names}
        self.epochs = None

    def _load_losses(self, file_path):
        df = pd.read_csv(file_path, index_col=False, delimiter=",", usecols=range(13))
        self.loss_df = df
        self.epochs = df.iloc[:, 0].to_numpy()
        for name in self.loss_names:
            self.loss_dict[name]["Train"] = df.loc[:, f"Train_{name}"].to_numpy()
            self.loss_dict[name]["Val"] = df.loc[:, f"Val_{name}"].to_numpy()

    def plot_loss_curve(self, file_path):
        self._load_losses(file_path)
        fig, axs = analysis.pyplot().subplots(6, 1, figsize=(6, 15), dpi=150)
        for i, (name, loss) in enumerate(self.loss_dict.items()):
            axs[i].plot(self.epochs, loss["Train"],
                        label=f"Train:{loss['Train'][-10:].mean():.4f}", lw=0.8, alpha=1)
            axs[i].plot(self.epochs, loss["Val"],
                        label=f"Val:{loss['Val'][-10:].mean():.4f}", lw=0.8, alpha=0.5)
            axs[i].set_title(name, y=1.0, pad=-14)
            axs[i].tick_params(axis="both", direction="in")
            axs[i].legend()
        return fig


class SpectraVariationEvaluator(Evaluator):
    """The decoder sweep over one style (reference
    ``analysis_new.py:166-243``); set ``.model`` and ``.styles`` first."""

    def __init__(self, n_spec=50, n_sampling=1000, amplitude=2.0):
        super().__init__(name="spectra_variation")
        self.n_spec = n_spec
        self.n_sampling = n_sampling
        self.amplitude = amplitude
        self.styles = None
        self.istyle = None
        self.model: Optional[InferenceModel] = None
        self.result = None

    def evaluate(self, istyle: int, true_range: bool = True, seed: int = 0):
        assert self.model is not None, "set .model (InferenceModel) first"
        _, spec_out = analysis.plot_spectra_variation(
            self.model, istyle, n_spec=self.n_spec, n_sampling=self.n_sampling or 0,
            true_range=true_range, styles=self.styles, amplitude=self.amplitude, seed=seed)
        self.result = spec_out
        self.istyle = istyle
        return spec_out

    def plot(self, ax=None, energy_grid=None):
        assert self.istyle is not None, "Please evaluate first!"
        colors = analysis.create_plotly_colormap(self.n_spec)
        fig = None
        if ax is None:
            fig, ax = analysis.pyplot().subplots(figsize=(8, 6))
        for spec, color in zip(self.result, colors):
            if energy_grid is None:
                ax.plot(spec, lw=0.8, c=color)
            else:
                ax.plot(energy_grid, spec, lw=0.8, c=color)
        ax.set_title(f"Varying Style #{self.istyle + 1}", y=1)
        return fig
