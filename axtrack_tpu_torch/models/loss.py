"""YOLO_AXTrack loss (reference machinelearning/loss.py:6-68).

PyTorch counterpart of ``axtrack_tpu/models/loss.py``: three sum-reduction
squared-error terms (coordinates of positive cells, object confidence,
no-object confidence) weighted by (lambda_coord, lambda_obj, lambda_noobj)
and divided by the batch size. Returns the loss and the components dict
the reference logs, under the same keys.
"""


def yolo_loss(predictions, target, Sy, Sx, lambda_obj=49.5,
              lambda_noobj=1.0, lambda_coord_anchor=49.5):
    """Args:
      predictions: f32[B, Sx, Sy, 3] (or flat [B, Sx*Sy*3]) model output.
      target: f32[B, Sx, Sy, C>=3] with channels (conf, x, y[, id]).

    Returns (loss, components): 0-dim tensors, components keyed
    total_no_object_loss, total_object_loss, total_xy_anchors_loss,
    total_summed_loss, total_pos_labels_rate.
    """
    bs = target.shape[0]
    target = target[..., :3]
    total_pos_labels_rate = target[..., 0].sum() / (bs * Sx * Sy)
    predictions = predictions.reshape(bs, Sx, Sy, 3)

    obj_exists = target[..., 0:1]
    true_xy = target[..., 1:3]
    no_obj_exists = 1.0 - obj_exists
    pred_conf = predictions[..., 0:1]
    pred_xy = predictions[..., 1:3]

    box_loss_anchors = ((pred_xy * obj_exists - true_xy) ** 2).sum()
    object_loss = ((pred_conf * obj_exists - obj_exists) ** 2).sum()
    no_object_loss = ((pred_conf * no_obj_exists) ** 2).sum()

    components = {
        'total_no_object_loss': lambda_noobj * no_object_loss / bs,
        'total_object_loss': lambda_obj * object_loss / bs,
        'total_xy_anchors_loss': lambda_coord_anchor * box_loss_anchors / bs,
    }
    loss = sum(components.values())
    components['total_summed_loss'] = loss
    components['total_pos_labels_rate'] = total_pos_labels_rate
    return loss, components


def make_loss_fn(params):
    """Bind the loss weights of the flat parameter dict, with the intended
    SY/SX (the reference passed Sy=P['SX'], core_functionality.py:89-90)."""
    def fn(predictions, target):
        return yolo_loss(predictions, target,
                         Sy=params['SY'], Sx=params['SX'],
                         lambda_obj=params['L_OBJECT'],
                         lambda_noobj=params['L_NOBJECT'],
                         lambda_coord_anchor=params['L_COORD_ANCHOR'])
    return fn
