"""The paper's comparison methods (Table 2), in PyTorch.

The counterparts of the JAX package's `baselines/`, on the same data and
defaults; each returns a model whose `.predict_topk(X, k)` gives (scores,
ids) (n, k) through `kernels/topk/ops.topk` (the blocked top-k kernel on
the card), ties to the lowest id as `lax.top_k` orders them. Trainers run
on the card unless the caller passes `device="cpu"`.

  l1_svm     l1-regularized OvR squared hinge (FISTA): the L1-SVM column
  leml       global low-rank embedding via alternating ridge: LEML
  sleec      cluster -> local SVD embedding -> kNN decode: SLEEC-lite
  fastxml    ensemble of balanced random feature-space trees: FastXML-lite
  pd_sparse  multiclass hinge with l1 prox: PD-Sparse-lite
"""

from repro_torch.baselines.l1_svm import train_l1_svm
from repro_torch.baselines.leml import train_leml
from repro_torch.baselines.sleec import train_sleec
from repro_torch.baselines.fastxml import train_fastxml
from repro_torch.baselines.pd_sparse import train_pd_sparse

__all__ = ["train_l1_svm", "train_leml", "train_sleec", "train_fastxml",
           "train_pd_sparse"]
