"""The demo as an interactive app (``dusty_gan_tpu/cli/app.py``): a
Streamlit front end over ``python -m dusty_gan_torch.cli.demo``.  The app
builds the demo CLI's arguments from its sidebar and shows the panels the
CLI writes, so the two cannot drift apart.

    streamlit run dusty_gan_torch/cli/app.py -- \\
        --model-path <checkpoint.pth> --config-path <config.yaml>

Streamlit is optional; without it the app exits, naming the headless CLI.
Without matplotlib the colour-map selector offers turbo alone, the one
table the port has built in.
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp
import tempfile

from dusty_gan_torch.cli import demo as demo_cli


def _streamlit():
    try:
        import streamlit as st
    except ImportError as e:
        raise SystemExit(
            "streamlit is not installed; use the headless CLI instead:\n"
            "  python -m dusty_gan_torch.cli.demo {synthesis,inversion} ..."
        ) from e
    return st


def _cli_paths():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--config-path", required=True)
    args, _ = parser.parse_known_args()
    return args.model_path, args.config_path


def _make_workdir() -> str:
    return tempfile.mkdtemp(prefix="dusty_gan_app_")


def _colormap_names() -> list:
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return ["turbo"]
    return sorted(plt.colormaps())


def _view_options(st) -> list:
    """The BEV camera and colour-map controls of both pages."""
    with st.sidebar.expander("view options", expanded=False):
        zoom = st.slider("zoom", min_value=1, max_value=120, value=60, step=1,
                         format="%dm")
        yaw = st.slider("yaw", min_value=-180, max_value=180, value=-45,
                        step=1, format="%d°")
        pitch = st.slider("pitch", min_value=0, max_value=90, value=60,
                          step=1, format="%d°")
        names = st.cache_resource(_colormap_names)()
        cmap = st.selectbox("color map", names, index=names.index("turbo"))
    return ["--view-zoom", str(zoom), "--view-yaw", str(yaw),
            "--view-pitch", str(pitch), "--cmap", cmap]


def _show_pngs(st, out_dir: str, caption: str):
    paths = sorted(glob.glob(osp.join(out_dir, "*.png")))
    if not paths:
        st.warning("no panels produced")
        return
    st.caption(caption)
    for p in paths:
        st.image(p, caption=osp.basename(p), use_column_width=True)


def synthesis_ui(st, model_path: str, config_path: str):
    with st.sidebar.expander("run options", expanded=True):
        num_samples = int(st.number_input("#samples", value=8, min_value=1, max_value=64))
        latent_type = st.selectbox("latent type", ["random", "lerp", "slerp"])
        seed = int(st.number_input("seed", value=0))
        video = st.checkbox("write interpolation video", value=False)
    view = _view_options(st)
    if st.button("run"):
        out = osp.join(st.cache_resource(_make_workdir)(), "synthesis")
        with st.spinner("generating…"):
            demo_cli.main(
                ["synthesis", "--model-path", model_path, "--config-path", config_path,
                 "--num-samples", str(num_samples), "--latent-type", latent_type,
                 "--seed", str(seed), "--out", out] + view
                + (["--video"] if video else [])
            )
        _show_pngs(st, out, f"{latent_type} synthesis, {num_samples} samples")
        if video:
            for v in glob.glob(osp.join(out, "*.gif")) + glob.glob(osp.join(out, "*.mp4")):
                st.video(v) if v.endswith(".mp4") else st.image(v)


def inversion_ui(st, model_path: str, config_path: str):
    with st.sidebar.expander("run options", expanded=True):
        index = int(st.number_input("test-set index", value=0, min_value=0))
        corruption = st.selectbox(
            "corruption",
            ["none", "additive noise", "low resolution", "dropout",
             "closing", "half", "quarter", "vlines"],
        )
        distance = st.multiselect("loss", ["l1", "l2", "chamfer"], default=["l1"])
        num_step = int(st.number_input("#iterations", value=1000, min_value=1))
        num_code = int(st.number_input("#codes (mGANprior)", value=1, min_value=1))
        compose_layer = int(st.number_input("compose layer", value=1, min_value=0, max_value=3))
        seed = int(st.number_input("seed", value=0))
    view = _view_options(st)
    if st.button("run"):
        out = osp.join(st.cache_resource(_make_workdir)(), "inversion")
        with st.spinner(f"optimizing latent for {num_step} steps…"):
            demo_cli.main(
                ["inversion", "--model-path", model_path, "--config-path", config_path,
                 "--index", str(index), "--corruption", corruption,
                 "--distance", ",".join(distance) or "l1",
                 "--num-step", str(num_step), "--num-code", str(num_code),
                 "--compose-layer", str(compose_layer),
                 "--seed", str(seed), "--out", out] + view
            )
        st.balloons()
        _show_pngs(st, out, f"inversion of test[{index}] under '{corruption}'")


def main():
    st = _streamlit()
    st.set_page_config(layout="wide")
    st.title("dusty-gan demo")
    st.text('"Learning to Drop Points for LiDAR Scan Synthesis" — PyTorch/CUDA port')

    model_path, config_path = _cli_paths()
    st.sidebar.title("settings")
    mode = st.sidebar.selectbox("mode", ["synthesis", "inversion"])
    if mode == "synthesis":
        synthesis_ui(st, model_path, config_path)
    else:
        inversion_ui(st, model_path, config_path)


if __name__ == "__main__":
    main()
