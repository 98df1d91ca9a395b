"""Evaluation and export (counterpart of ``vqatpu.eval``): the FFOE sweep,
its score, the EvalAI and teacher-logit files, TDIUC's per-type metrics,
and the multiple-choice (Visual7W) sweep and scores."""

from vqatpu_torch.eval.ffoe import (ensemble_logits, evaluate, export_results,
                                    get_logits, make_json,
                                    make_json_with_logits)
from vqatpu_torch.eval.mc import (compute_score_mc, compute_score_with_emb,
                                  evaluate_mc)
from vqatpu_torch.eval.tdiuc import (align_predictions, format_report,
                                     load_answerkey, mean_per_type)

__all__ = ["align_predictions", "compute_score_mc", "compute_score_with_emb",
           "ensemble_logits", "evaluate", "evaluate_mc", "export_results",
           "format_report", "get_logits", "load_answerkey", "make_json",
           "make_json_with_logits", "mean_per_type"]
