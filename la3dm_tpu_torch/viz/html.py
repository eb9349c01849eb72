"""Self-contained HTML map viewer — the RViz replacement for inspection.

The reference's visual story is RViz CUBE_LIST markers
(``include/common/markerarray_pub.h``).  This writes ONE dependency-free
.html file: the occupied/free voxel sets embedded as base64 float/byte
arrays, rendered with raw WebGL point sprites (square gl_PointSize), with
mouse orbit/zoom and an occupied/free toggle.  Colors reproduce the
reference's semantics — height-mapped HSV for OCCUPIED
(``markerarray_pub.h:12-73``), gray→color probability ramp for FREE
(``:137-146``) — via viz/colormap.py.  (The port's own copy of
``la3dm_tpu/viz/html.py``; the page is byte for byte the JAX package's, its
title included.)
"""

from __future__ import annotations

import base64
import json

import numpy as np

from la3dm_tpu_torch.viz import colormap

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>la3dm_tpu map</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.55);padding:8px 10px;border-radius:6px}
 label{margin-right:10px;user-select:none}
 canvas{display:block}
</style></head><body>
<div id="hud">
 <b>la3dm_tpu</b> — __META__<br>
 <label><input type="checkbox" id="occ" checked> occupied (__NOCC__)</label>
 <label><input type="checkbox" id="free"> free (__NFREE__)</label>
 <span id="fps"></span><br>
 <small>drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</small>
</div>
<canvas id="c"></canvas>
<script>
const OCC_POS="__OCC_POS__", OCC_COL="__OCC_COL__", OCC_SIZE="__OCC_SIZE__";
const FREE_POS="__FREE_POS__", FREE_COL="__FREE_COL__", FREE_SIZE="__FREE_SIZE__";
const CENTER=__CENTER__, RADIUS=__RADIUS__, RES=__RES__;
function f32(b64){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new Float32Array(u.buffer);}
function u8(b64){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return u;}
const canvas=document.getElementById("c");
const gl=canvas.getContext("webgl",{antialias:false});
const vs=`attribute vec3 p;attribute vec3 col;attribute float sz;
uniform mat4 mvp;uniform float scale;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);
 gl_PointSize=clamp(sz*scale/max(gl_Position.w,0.01),1.0,64.0);vc=col;}`;
const fs=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function shader(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,shader(gl.VERTEX_SHADER,vs));
gl.attachShader(prog,shader(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,"p"),aC=gl.getAttribLocation(prog,"col"),
 aS=gl.getAttribLocation(prog,"sz");
const uMVP=gl.getUniformLocation(prog,"mvp"),uSc=gl.getUniformLocation(prog,"scale");
function mkset(posB,colB,szB){const pos=f32(posB),col=u8(colB),sz=f32(szB);
 const n=sz.length;const o={n:n,vp:gl.createBuffer(),vc:gl.createBuffer(),vs:gl.createBuffer()};
 gl.bindBuffer(gl.ARRAY_BUFFER,o.vp);gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
 gl.bindBuffer(gl.ARRAY_BUFFER,o.vc);
 const colf=new Float32Array(col.length);for(let i=0;i<col.length;i++)colf[i]=col[i]/255;
 gl.bufferData(gl.ARRAY_BUFFER,colf,gl.STATIC_DRAW);
 gl.bindBuffer(gl.ARRAY_BUFFER,o.vs);gl.bufferData(gl.ARRAY_BUFFER,sz,gl.STATIC_DRAW);
 return o;}
const occ=mkset(OCC_POS,OCC_COL,OCC_SIZE),fre=mkset(FREE_POS,FREE_COL,FREE_SIZE);
let yaw=0.8,pitch=0.5,dist=RADIUS*2.5,panX=0,panY=0;
function mat(){
 const a=canvas.width/canvas.height,f=1.0/Math.tan(0.4),near=0.05,far=RADIUS*40;
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 // camera orbiting CENTER
 const ex=CENTER[0]+dist*cy*cp,ey=CENTER[1]+dist*sy*cp,ez=CENTER[2]+dist*sp;
 const zx=ex-CENTER[0],zy=ey-CENTER[1],zz=ez-CENTER[2];
 const zl=Math.hypot(zx,zy,zz);const Z=[zx/zl,zy/zl,zz/zl];
 const up=[0,0,1];
 let X=[up[1]*Z[2]-up[2]*Z[1],up[2]*Z[0]-up[0]*Z[2],up[0]*Z[1]-up[1]*Z[0]];
 const xl=Math.hypot(...X);X=[X[0]/xl,X[1]/xl,X[2]/xl];
 const Y=[Z[1]*X[2]-Z[2]*X[1],Z[2]*X[0]-Z[0]*X[2],Z[0]*X[1]-Z[1]*X[0]];
 const tx=-(X[0]*ex+X[1]*ey+X[2]*ez)+panX,
       ty=-(Y[0]*ex+Y[1]*ey+Y[2]*ez)+panY,
       tz=-(Z[0]*ex+Z[1]*ey+Z[2]*ez);
 const view=[X[0],Y[0],Z[0],0, X[1],Y[1],Z[1],0, X[2],Y[2],Z[2],0, tx,ty,tz,1];
 const proj=[f/a,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0];
 const m=new Float32Array(16);
 for(let r=0;r<4;r++)for(let c=0;c<4;c++){let s=0;
  for(let k=0;k<4;k++)s+=view[r*4+k]*proj[k*4+c];m[r*4+c]=s;}
 return m;}
function draw(){
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.07,0.07,0.08,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(uMVP,false,mat());
 gl.uniform1f(uSc,canvas.height*1.1);
 for(const [o,box] of [[fre,"free"],[occ,"occ"]]){
  if(!document.getElementById(box).checked)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,o.vp);gl.enableVertexAttribArray(aP);
  gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,o.vc);gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,o.vs);gl.enableVertexAttribArray(aS);
  gl.vertexAttribPointer(aS,1,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.POINTS,0,o.n);}
}
let drag=false,px=0,py=0,shift=false;
canvas.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;shift=e.shiftKey;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
 if(shift){panX+=dx*dist*0.001;panY-=dy*dist*0.001;}
 else{yaw-=dx*0.008;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008));}draw();};
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();};
onresize=draw;
document.getElementById("occ").onchange=draw;
document.getElementById("free").onchange=draw;
draw();
</script></body></html>
"""


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def export_html(path: str, leaves: dict, resolution: float,
                title: str = "") -> int:
    """Write a single-file WebGL viewer for a leaves dict (models.leaves()).

    Returns the number of voxels embedded."""
    state = leaves["state"]
    occ = state == 1
    fre = state == 0
    pos = np.stack([leaves["x"], leaves["y"], leaves["z"]], -1).astype(np.float32)
    size = leaves["size"].astype(np.float32)

    def colors(sel, occupied):
        if occupied:
            zmin = float(leaves["z"][sel].min()) if sel.any() else 0.0
            zmax = float(leaves["z"][sel].max()) if sel.any() else 1.0
            c = colormap.occupied_colors(leaves["z"][sel], zmin, zmax)
        else:
            c = colormap.free_colors(leaves["prob"][sel])
        return np.clip(c * 255.0, 0, 255).astype(np.uint8)

    center = pos.mean(0) if len(pos) else np.zeros(3, np.float32)
    radius = float(np.linalg.norm(pos - center, axis=1).max()) if len(pos) else 1.0

    html = (_TEMPLATE
            .replace("__META__", json.dumps(title)[1:-1] or "map")
            .replace("__NOCC__", str(int(occ.sum())))
            .replace("__NFREE__", str(int(fre.sum())))
            .replace("__OCC_POS__", _b64(pos[occ]))
            .replace("__OCC_COL__", _b64(colors(occ, True)))
            .replace("__OCC_SIZE__", _b64(size[occ]))
            .replace("__FREE_POS__", _b64(pos[fre]))
            .replace("__FREE_COL__", _b64(colors(fre, False)))
            .replace("__FREE_SIZE__", _b64(size[fre]))
            .replace("__CENTER__", json.dumps([float(v) for v in center]))
            .replace("__RADIUS__", json.dumps(radius))
            .replace("__RES__", json.dumps(float(resolution))))
    with open(path, "w") as f:
        f.write(html)
    return int(occ.sum() + fre.sum())
