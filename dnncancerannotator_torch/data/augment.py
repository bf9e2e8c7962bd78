'''Feature/label split (counterpart of
dnncancerannotator_tpu.data.augment.to_feature_label; the augmentation
chain is not ported yet).'''


def to_feature_label(images, slice_types):
    '''Split [B, H, W, C] into (x [B,H,W,C-1], y [B,H,W]) by the label
    channel.'''
    slice_types = list(slice_types)
    label_index = slice_types.index('label')
    feature_indices = [i for i in range(len(slice_types)) if i != label_index]
    x = images[..., feature_indices]
    y = images[..., label_index]
    return x, y
