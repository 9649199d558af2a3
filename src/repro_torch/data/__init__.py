"""Data of the port (counterpart of ``repro.data``): the synthetic
corpora and tasks, the MLM / ELECTRA corruptions and the sharded
loader."""
from repro_torch.data.synthetic import (
    MarkovCorpus, mlm_mask, electra_corrupt, classification_task,
    token_task, zipf_probs, PAD_ID, CLS_ID, SEP_ID, MASK_ID, N_SPECIAL,
)
from repro_torch.data.loader import ShardedLoader

__all__ = ["MarkovCorpus", "mlm_mask", "electra_corrupt",
           "classification_task", "token_task", "zipf_probs",
           "ShardedLoader", "PAD_ID", "CLS_ID", "SEP_ID", "MASK_ID",
           "N_SPECIAL"]
