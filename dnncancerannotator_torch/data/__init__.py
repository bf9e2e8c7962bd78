from .pipeline import EvalDataset, eval_ds, predict_ds
from . import augment, records, tfrecord
