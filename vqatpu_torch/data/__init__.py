"""Data (counterpart of ``vqatpu.data``): the dictionary, feature stores,
the FFOE and Visual7W datasets, static-shape loaders, tf-idf and synthetic
fixtures."""

from vqatpu_torch.data.batching import (BatchLoader, PrefetchLoader,
                                        make_eval_loader, stack_samples)
from vqatpu_torch.data.datasets import (ConcatDataset, TDIUCFeatureDataset,
                                        VisualGenomeFeatureDataset,
                                        VQAFeatureDataset)
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.features import FeatureStore, ZeroArray
from vqatpu_torch.data.mc_dataset import (MC_ANS_LEN, MC_QUESTION_LEN,
                                          NUM_CANDIDATES, V7WDataset,
                                          expand_mc_batch, load_v7w_entries)

__all__ = ["BatchLoader", "ConcatDataset", "Dictionary", "FeatureStore",
           "MC_ANS_LEN", "MC_QUESTION_LEN", "NUM_CANDIDATES", "PrefetchLoader",
           "TDIUCFeatureDataset", "V7WDataset", "VQAFeatureDataset",
           "VisualGenomeFeatureDataset", "ZeroArray", "expand_mc_batch",
           "load_v7w_entries", "make_eval_loader", "stack_samples"]
