from .pipeline import EvalDataset, TrainDataset, eval_ds, predict_ds, train_ds
from . import augment, records, tfrecord
