"""Evaluation and export (counterpart of ``vqatpu.eval``): the FFOE sweep,
its score, the EvalAI and teacher-logit files, and TDIUC's per-type
metrics."""

from vqatpu_torch.eval.ffoe import (ensemble_logits, evaluate, export_results,
                                    get_logits, make_json,
                                    make_json_with_logits)
from vqatpu_torch.eval.tdiuc import (align_predictions, format_report,
                                     load_answerkey, mean_per_type)

__all__ = ["align_predictions", "ensemble_logits", "evaluate",
           "export_results", "format_report", "get_logits", "load_answerkey",
           "make_json", "make_json_with_logits", "mean_per_type"]
