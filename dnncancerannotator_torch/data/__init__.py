from .pipeline import EvalDataset, TrainDataset, eval_ds, predict_ds, train_ds
from .records import generate_tfrecords
from . import augment, records, tfrecord
