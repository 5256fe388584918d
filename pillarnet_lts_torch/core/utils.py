"""Misc core helpers (the port's own copy of
`pillarnet_lts_tpu/core/utils.py`)."""


def set_by_task_cfg(test_cfg, task_num_classes):
    """Re-organize flat per-class test params into per-task lists.

    Port of `det3d/core/utils/center_utils.py:229-274`. Scalars pass through;
    flat per-class lists of length sum(task_num_classes) are regrouped as
    [per-task [per-class]] lists. Used by the multi-class NMS configs (the
    Waymo ones), whose NMS sizes and thresholds are given per class.
    """

    def _param_org(param):
        if isinstance(param, (float, int)):
            return param
        if not isinstance(param, (list, tuple)):
            raise TypeError(f"per-class param must be a list, got {param!r}")
        if len(param) != sum(task_num_classes):
            raise ValueError(f"{len(param)} per-class values for "
                             f"{sum(task_num_classes)} classes")
        ret_list = []
        flag = 0
        for num in task_num_classes:
            ret_list.append(list(param[flag:flag + num]))
            flag += num
        return ret_list

    test_cfg = dict(test_cfg)
    if test_cfg.get("rectifier", False):
        test_cfg["rectifier"] = _param_org(test_cfg["rectifier"])
    if test_cfg.get("use_rectify", False):
        test_cfg["use_rectify"] = _param_org(test_cfg["use_rectify"])

    nms = dict(test_cfg["nms"])
    nms["nms_pre_max_size"] = _param_org(nms["nms_pre_max_size"])
    nms["nms_post_max_size"] = _param_org(nms["nms_post_max_size"])
    nms["nms_iou_threshold"] = _param_org(nms["nms_iou_threshold"])
    test_cfg["nms"] = nms
    return test_cfg
