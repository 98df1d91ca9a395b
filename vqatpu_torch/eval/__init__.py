"""Evaluation and export (counterpart of ``vqatpu.eval``): the FFOE sweep,
its score and the EvalAI and teacher-logit files."""

from vqatpu_torch.eval.ffoe import (ensemble_logits, evaluate, export_results,
                                    get_logits, make_json,
                                    make_json_with_logits)

__all__ = ["ensemble_logits", "evaluate", "export_results", "get_logits",
           "make_json", "make_json_with_logits"]
