"""Data (counterpart of ``vqatpu.data``): the dictionary, feature stores,
the FFOE datasets, static-shape loaders, tf-idf and synthetic fixtures."""

from vqatpu_torch.data.batching import (BatchLoader, PrefetchLoader,
                                        make_eval_loader, stack_samples)
from vqatpu_torch.data.datasets import (ConcatDataset, TDIUCFeatureDataset,
                                        VisualGenomeFeatureDataset,
                                        VQAFeatureDataset)
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.features import FeatureStore

__all__ = ["BatchLoader", "ConcatDataset", "Dictionary", "FeatureStore",
           "PrefetchLoader", "TDIUCFeatureDataset", "VQAFeatureDataset",
           "VisualGenomeFeatureDataset", "make_eval_loader", "stack_samples"]
