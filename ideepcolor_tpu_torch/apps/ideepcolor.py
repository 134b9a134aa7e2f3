"""CLI entry point: the interactive colorization app on the card.

Counterpart of ``ideepcolor_tpu/apps/ideepcolor.py``: the reference
launcher's flags and backend selection (ref: ideepcolor.py:13-85) over the
port's backends. The models run on the card ``cuda:<--gpu>`` unless
``--cpu_mode``. Run: ``python -m ideepcolor_tpu_torch.apps.ideepcolor
[--backend ...]``.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='interactive deep colorization on the card')
    parser.add_argument('--win_size', dest='win_size', type=int, default=512,
                        help='the size of the GUI drawing pad')
    parser.add_argument('--image_file', dest='image_file', type=str,
                        default='./test_imgs/mortar_pestle.jpg',
                        help='input image')
    parser.add_argument('--gpu', dest='gpu', type=int, default=0,
                        help='the card to run on: cuda:<gpu>')
    parser.add_argument('--cpu_mode', dest='cpu_mode', action='store_true',
                        help='run on the CPU instead of the card')
    parser.add_argument('--backend', dest='backend', type=str,
                        default='siggraph',
                        choices=['siggraph', 'caffe', 'pytorch'],
                        help='model family: siggraph (alias pytorch) or '
                             'the caffe graph variants')
    parser.add_argument('--color_model', dest='color_model', type=str,
                        default='', help='checkpoint (.pth/.npz) for the '
                                         'colorization model')
    # reference-CLI parity flags for the caffe graph paths
    # (ref ideepcolor.py:17-31); prototxt paths are accepted and ignored
    # (the graph structure is built in)
    parser.add_argument('--color_prototxt', type=str, default='',
                        help='accepted for parity; unused')
    parser.add_argument('--color_caffemodel', type=str, default='',
                        help='caffe weights (.caffemodel, .npz or .pth) for '
                             'the color model')
    parser.add_argument('--dist_prototxt', type=str, default='',
                        help='accepted for parity; unused')
    parser.add_argument('--dist_caffemodel', type=str, default='',
                        help='caffe weights (.caffemodel, .npz or .pth) for '
                             'the dist model')
    parser.add_argument('--dist_model', dest='dist_model', type=str,
                        default='', help='checkpoint for the distribution '
                                         'model')
    parser.add_argument('--no_dist', dest='no_dist', action='store_true',
                        help='disable the color-suggestion model')
    parser.add_argument('--load_size', dest='load_size', type=int,
                        default=256, help='network input resolution')
    parser.add_argument('--pytorch_maskcent', dest='pytorch_maskcent',
                        action='store_true',
                        help='subtract 0.5 from the hint mask (retrained '
                             'checkpoints)')
    parser.add_argument('--dtype', type=str, default='bfloat16',
                        help='model precision: bfloat16 (default, the '
                             'serving mode on the tensor cores, as '
                             'apps.serve) or float32 for parity output')
    return parser.parse_args(argv)


def build_models(args):
    """(color_model, dist_model or None) on ``cuda:<gpu>``, or on the CPU
    with ``--cpu_mode``."""
    from .. import api
    device = "cpu" if args.cpu_mode else f"cuda:{args.gpu}"
    if args.backend in ('siggraph', 'pytorch'):
        from ..config import bundled_weights
        weights = args.color_model or bundled_weights("teacher")
        if weights and not args.color_model:
            print(f"using bundled demo weights: {weights}")
        color_model = api.ColorizeImageTorch(
            Xd=args.load_size, maskcent=args.pytorch_maskcent, device=device)
        color_model.prep_net(path=weights, dtype=args.dtype)
        dist_model = None
        if not args.no_dist:
            dist_model = api.ColorizeImageTorchDist(
                Xd=args.load_size, maskcent=args.pytorch_maskcent,
                device=device)
            dist_model.prep_net(path=args.dist_model or weights,
                                dtype=args.dtype)
    else:
        color_model = api.ColorizeImageTorchCaffe(Xd=args.load_size,
                                                  device=device)
        color_model.prep_net(
            args.gpu, prototxt_path=args.color_prototxt,
            caffemodel_path=args.color_caffemodel or args.color_model,
            dtype=args.dtype)
        dist_model = None
        if not args.no_dist:
            dist_model = api.ColorizeImageTorchCaffeDist(Xd=args.load_size,
                                                         device=device)
            dist_model.prep_net(
                args.gpu, prototxt_path=args.dist_prototxt,
                caffemodel_path=args.dist_caffemodel or args.dist_model,
                S=0.2, dtype=args.dtype)
    return color_model, dist_model


def main(argv=None):
    args = parse_args(argv)
    for k, v in sorted(vars(args).items()):
        print(f'{k}: {v}')
    color_model, dist_model = build_models(args)

    try:
        from PyQt5.QtWidgets import QApplication
        from ..ui.qt_gui import GUIDesign
    except ImportError:
        print('PyQt5 is not installed; the GUI is unavailable.\n'
              'Use the headless API instead (ideepcolor_tpu_torch.api) or '
              'the notebook-style demos in '
              'ideepcolor_tpu_torch/apps/demos.py.')
        return 1

    app = QApplication(sys.argv)
    window = GUIDesign(color_model, dist_model=dist_model,
                       img_file=args.image_file, load_size=args.load_size,
                       win_size=args.win_size)
    window.show()
    return app.exec_()


if __name__ == '__main__':
    raise SystemExit(main())
